"""The port's render farm (``farm/``): runner chunking, missing-chunk resume
and retries; the shared-filesystem broker with real worker processes
(``python -m facebook360_dep_tpu_torch.farm.worker``), lease expiry after a
SIGKILL, the watchdog and stale ``done/`` entries; transfers; and the GPU
fleet's lifecycle dry and against a fake ``gcloud``. These mirror
tests/test_farm.py and tests/test_transfer_cluster.py on the port's modules;
the module names the port's argv carry are the port's, never the JAX
package's."""

import json
import os
import signal
import stat
import subprocess
import sys
import time

import numpy as np
import pytest

from facebook360_dep_tpu_torch.farm import broker, cluster, runner, transfer, worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chunk_frames():
    chunks = runner.chunk_frames(0, 9, 4)
    assert [(c.first, c.last) for c in chunks] == [(0, 3), (4, 7), (8, 9)]
    assert chunks[0].name == "000000_000003"
    assert chunks[2].frames() == ["000008", "000009"]


def test_resume_skips_complete_chunks(tmp_path):
    ran = []

    def outputs(chunk):
        return [str(tmp_path / f"{chunk.name}.out")]

    def run(chunk):
        ran.append(chunk.name)
        (tmp_path / f"{chunk.name}.out").write_text("done")

    stage = runner.Stage(name="s", outputs=outputs, run=run)
    chunks = runner.chunk_frames(0, 5, 2)
    pipeline = runner.Pipeline(workers=1)
    pipeline.run_stage(stage, chunks)
    assert len(ran) == 3
    pipeline.run_stage(stage, chunks)  # everything cached
    assert len(ran) == 3
    os.unlink(tmp_path / "000002_000003.out")  # only that chunk reruns
    pipeline.run_stage(stage, chunks)
    assert ran.count("000002_000003") == 2
    runner.Pipeline(workers=1, force_recompute=True).run_stage(stage, chunks)
    assert len(ran) == 7


def test_retry_then_fail_and_flaky_recovery(tmp_path):
    attempts = {"n": 0}

    def boom(chunk):
        attempts["n"] += 1
        raise ValueError("boom")

    stage = runner.Stage(name="s", outputs=lambda c: [str(tmp_path / "never.out")], run=boom)
    with pytest.raises(RuntimeError, match="exhausted retries"):
        runner.Pipeline(workers=1, max_retries=2).run_stage(stage, runner.chunk_frames(0, 0, 1))
    assert attempts["n"] == 3  # initial + 2 retries

    state = {"fails_left": 1}

    def flaky(chunk):
        if state["fails_left"] > 0:
            state["fails_left"] -= 1
            raise ValueError("transient")
        (tmp_path / f"{chunk.name}.out").write_text("done")

    stage = runner.Stage(name="s", outputs=lambda c: [str(tmp_path / f"{c.name}.out")], run=flaky)
    runner.Pipeline(workers=1, max_retries=2).run_stage(stage, runner.chunk_frames(0, 0, 1))
    assert (tmp_path / "000000_000000.out").exists()


def test_parallel_subprocess_stage_with_lambdas(tmp_path):
    """workers > 1 runs a stage's subprocess commands in parallel; the
    stage's lambdas stay in this process (the JAX package's process pool
    cannot pickle them), and a failing chunk is retried, then raises."""
    out = tmp_path / "out"
    out.mkdir()
    stage = runner.Stage(name="touch", outputs=lambda c: [str(out / c.name)],
                         command=lambda c: [sys.executable, "-c", f"open(r'{out / c.name}', 'w').write('x')"])
    chunks = runner.chunk_frames(0, 5, 1)
    runner.Pipeline(workers=3).run_stage(stage, chunks)
    assert sorted(os.listdir(out)) == [c.name for c in chunks]
    bad = runner.Stage(name="bad", outputs=lambda c: [str(out / "never")],
                       command=lambda c: [sys.executable, "-c", "raise SystemExit(4)"])
    with pytest.raises(RuntimeError, match="exhausted retries"):
        runner.Pipeline(workers=2, max_retries=1).run_stage(bad, chunks[:2])


def test_commands_name_the_port():
    argv = runner.python_module_command("derp_cli", {"input_root": "/a", "first": "000000"})
    assert argv[:3] == [sys.executable, "-m", "facebook360_dep_tpu_torch.cli.derp_cli"]
    assert argv[-2:] == ["--input_root=/a", "--first=000000"]
    argv = worker.build_argv({"module": "resize_images", "flags": {"rig": "r.json"}})
    assert argv == [sys.executable, "-m", "facebook360_dep_tpu_torch.cli.resize_images", "--rig=r.json"]
    assert worker.build_argv({"argv": ["true", "x"]}) == ["true", "x"]


# ---- cross-process broker (farm.broker + farm.worker) -----------------------


def _spawn_worker(queue_dir, worker_id, once=True, max_retries=1):
    env = dict(os.environ, PYTHONPATH=REPO)
    argv = [sys.executable, "-m", "facebook360_dep_tpu_torch.farm.worker", "--queue_dir", str(queue_dir),
            "--worker_id", worker_id, "--max_retries", str(max_retries)]
    if once:
        argv.append("--once")
    return subprocess.Popen(argv, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def test_broker_two_workers_split_jobs(tmp_path):
    """Two worker processes drain one queue; each job runs exactly once."""
    q = broker.FileQueue(str(tmp_path / "q"))
    out = tmp_path / "out"
    out.mkdir()
    for i in range(6):
        q.publish(f"job{i}", {"argv": [sys.executable, "-c", f"open(r'{out}/j{i}', 'w').write('x')"]})
    w1 = _spawn_worker(tmp_path / "q", "w1")
    w2 = _spawn_worker(tmp_path / "q", "w2")
    q.await_drain(expected_done=6, timeout=60, no_worker_timeout=30)
    w1.wait(timeout=30)
    w2.wait(timeout=30)
    assert w1.returncode == 0 and w2.returncode == 0
    assert sorted(os.listdir(out)) == [f"j{i}" for i in range(6)]
    done = sorted(os.listdir(tmp_path / "q" / "done"))
    assert len(done) == 6
    workers = set()
    for fn in done:
        with open(tmp_path / "q" / "done" / fn) as f:
            workers.add(json.load(f)["result"]["worker"])
    assert workers <= {"w1", "w2"}


def test_worker_sigkilled_mid_chunk_is_requeued(tmp_path):
    """SIGKILL a worker while it holds a chunk: the lease expires, the
    master requeues the job and another worker completes it."""
    q = broker.FileQueue(str(tmp_path / "q"))
    out = tmp_path / "done_marker"
    pid = tmp_path / "slow.pid"
    q.publish("slowjob", {"argv": [sys.executable, "-c", f"import os, time; open(r'{pid}', 'w').write(str(os.getpid())); "
                                   f"time.sleep(120); open(r'{out}', 'w').write('x')"]})
    victim = _spawn_worker(tmp_path / "q", "victim", once=False)
    deadline = time.time() + 30
    claimed_dir = tmp_path / "q" / "claimed"
    while time.time() < deadline and not os.listdir(claimed_dir):
        time.sleep(0.05)
    assert os.listdir(claimed_dir), "worker never claimed the job"
    victim.send_signal(signal.SIGKILL)
    victim.wait(timeout=30)
    deadline = time.time() + 30
    while time.time() < deadline and not (pid.exists() and pid.read_text()):
        time.sleep(0.05)
    os.kill(int(pid.read_text()), signal.SIGKILL)  # the orphaned chunk command
    time.sleep(1.2)
    assert q.requeue_stale_claims(lease=1.0) == ["slowjob"]
    with open(tmp_path / "q" / "queue" / "slowjob.json", "r+") as f:
        msg = json.load(f)
        msg["argv"] = [sys.executable, "-c", f"open(r'{out}', 'w').write('x')"]
        f.seek(0)
        json.dump(msg, f)
        f.truncate()
    rescuer = _spawn_worker(tmp_path / "q", "rescuer")
    q.await_drain(expected_done=1, timeout=60, no_worker_timeout=30, lease=3600)
    rescuer.wait(timeout=30)
    assert out.exists()
    with open(tmp_path / "q" / "done" / "slowjob.json") as f:
        assert json.load(f)["result"]["worker"] == "rescuer"


def test_failed_job_requeued_then_parked(tmp_path):
    q = broker.FileQueue(str(tmp_path / "q"))
    q.publish("bad", {"argv": [sys.executable, "-c", "raise SystemExit(3)"]})
    for _ in range(2):  # --once exits on an empty queue: a second run takes the requeued attempt
        _spawn_worker(tmp_path / "q", "w", once=True, max_retries=1).wait(timeout=60)
    with pytest.raises(RuntimeError, match="failed permanently"):
        q.await_drain(expected_done=1, timeout=10, no_worker_timeout=5)
    with open(tmp_path / "q" / "failed" / "bad.json") as f:
        msg = json.load(f)
    assert msg["attempts"] == 2 and "rc=3" in msg["last_error"]


def test_master_watchdog_no_workers(tmp_path):
    q = broker.FileQueue(str(tmp_path / "q"))
    q.publish("lonely", {"argv": ["true"]})
    with pytest.raises(RuntimeError, match="no live workers"):
        q.await_drain(expected_done=1, timeout=30, no_worker_timeout=0.5)
    with pytest.raises(TimeoutError):
        q.await_drain(expected_done=1, timeout=0.3, no_worker_timeout=30)


def test_distributed_pipeline_end_to_end(tmp_path):
    """DistributedPipeline master + a real worker process: publish, drain,
    then resume-skip on rerun with no worker alive."""
    out = tmp_path / "out"
    out.mkdir()
    stage = runner.Stage(name="write", outputs=lambda c: [str(out / f"{c.name}.txt")],
                         command=lambda c: [sys.executable, "-c", f"open(r'{out}/{c.name}.txt', 'w').write('ok')"])
    chunks = runner.chunk_frames(0, 7, 2)
    master = runner.DistributedPipeline(str(tmp_path / "q"), no_worker_timeout=30, stage_timeout=60)
    w = _spawn_worker(tmp_path / "q" / "write", "w1")
    master.run([stage], chunks)
    w.wait(timeout=30)
    assert sorted(os.listdir(out)) == [f"{c.name}.txt" for c in chunks]
    master.run([stage], chunks)


def test_dotted_worker_id_and_stale_done_entries(tmp_path):
    q = broker.FileQueue(str(tmp_path / "q"))
    q.publish("jobA", {"argv": ["true"]})
    path, msg = q.claim("host.sub.example.com")
    assert msg["job_id"] == "jobA" and os.path.basename(path) == "host-sub-example-com.jobA.json"
    time.sleep(0.01)
    assert q.requeue_stale_claims(lease=0.0) == ["jobA"]
    path, _ = q.claim("other.host")
    q.ack(path, {"worker": "other"})
    assert sorted(os.listdir(tmp_path / "q" / "done")) == ["jobA.json"]

    # a previous run's done/ entries must not satisfy this run's drain
    with open(tmp_path / "q" / "done" / "jobZ.json", "w") as f:
        json.dump({"job_id": "jobZ"}, f)
    q.publish("jobA", {"argv": ["true"]})  # re-published: its stale done entry is cleared
    assert not os.path.exists(tmp_path / "q" / "done" / "jobA.json")
    with pytest.raises(TimeoutError):
        q.await_drain(expected_done=1, timeout=0.5, no_worker_timeout=30, jobs=["jobA"])
    path, _ = q.claim("w1")
    q.ack(path, {"worker": "w1"})
    with open(tmp_path / "q" / "failed" / "jobQ.json", "w") as f:
        json.dump({"job_id": "jobQ"}, f)
    q.await_drain(expected_done=1, timeout=5, no_worker_timeout=30, jobs=["jobA"])


# ---- transfers --------------------------------------------------------------


def test_address_and_transfer_commands(tmp_path):
    a = transfer.Address.parse("gs://bucket/path/x")
    assert a.protocol == "gs" and a.path == "bucket/path/x" and a.is_remote
    assert a.join("color", "cam0").uri() == "gs://bucket/path/x/color/cam0"
    b = transfer.Address.parse("/local/dir")
    assert not b.is_remote and b.uri() == "/local/dir"
    assert transfer.Address.parse("s3://b/k").protocol == "s3"
    cmd = transfer.transfer("gs://b/x", "/local", sync=True, dry_run=True)
    assert cmd[0] == "gsutil" and "rsync" in cmd
    assert transfer.transfer("s3://b/x", "/local", sync=True, dry_run=True)[:3] == ["aws", "s3", "sync"]
    assert transfer.transfer("gs://b/x", "/l", sync=False, dry_run=True) == ["gsutil", "-m", "cp", "-r", "gs://b/x", "/l"]
    with pytest.raises(ValueError, match="no transfer tool"):
        transfer.transfer("smb://host/x", "/l", dry_run=True)

    src = tmp_path / "src" / "a.txt"
    src.parent.mkdir()
    src.write_text("hello")
    transfer.transfer(str(src), str(tmp_path / "dst" / "a.txt"))
    assert (tmp_path / "dst" / "a.txt").read_text() == "hello"
    transfer.transfer(str(tmp_path / "src"), str(tmp_path / "dst2"))
    assert (tmp_path / "dst2" / "a.txt").read_text() == "hello"


def test_frame_tar_roundtrip(tmp_path):
    from facebook360_dep_tpu_torch.core import imagetypes, io

    root = tmp_path / "proj"
    for cam_id in ("cam0", "cam1"):
        d = imagetypes.image_dir(str(root), "color", None, cam_id)
        os.makedirs(d)
        for frame in ("000003", "000004"):
            io.write_color(os.path.join(d, frame + ".png"), np.zeros((4, 4, 3), np.float32))
    tar = transfer.pack_frame_tar(str(root), "000003", str(tmp_path / "f.tar"), ["color", "disparity"])
    names = transfer.unpack_frame_tar(tar, str(tmp_path / "out"))
    assert sorted(names) == ["video/color/cam0/000003.png", "video/color/cam1/000003.png"]
    assert (tmp_path / "out" / "video" / "color" / "cam1" / "000003.png").read_bytes() == \
        (root / "video" / "color" / "cam1" / "000003.png").read_bytes()


# ---- the GPU fleet ----------------------------------------------------------


def test_fleet_dry_run_lifecycle():
    cfg = cluster.ClusterConfig(name="t", workers=2, gcs_root="gs://b/proj", project="p")
    fleet = cluster.GpuFleet(cfg, dry_run=True)
    fleet.create()
    fleet.deploy("/repo")
    fleet.run_render("gs://b/proj/in", "gs://b/proj/out", first=0, last=9, chunk_size=2)
    fleet.monitor_and_terminate()  # dry run: one idle poll, no teardown yet
    fleet.terminate()
    plan = fleet.plan()
    assert plan.count("compute instances create") == 2
    assert "--accelerator=type=nvidia-h100-80gb,count=1" in plan and "--machine-type=a3-highgpu-1g" in plan
    assert "--project=p" in plan and "tpu-vm" not in plan
    assert "--first=000000" in plan and "--last=000004" in plan
    assert "--first=000005" in plan and "--last=000009" in plan
    assert plan.count("facebook360_dep_tpu_torch.cli.render_pipeline") == 2
    assert "facebook360_dep_tpu.cli" not in plan
    assert plan.count("compute instances delete") == 2
    assert fleet.issued[2][:4] == ["gsutil", "-m", "rsync", "-r"]


def test_fleet_cli_dry_run(capsys):
    fleet = cluster.main(["--workers", "2", "--input_root", "gs://b/in", "--output_root", "gs://b/out",
                          "--first", "0", "--last", "3", "--dry_run", "--gcs_root", "gs://b/ws"])
    out = capsys.readouterr().out
    assert "compute instances create" in out and "render_pipeline" in out
    assert len(fleet.issued) >= 4


def test_fleet_against_fake_gcloud(tmp_path, monkeypatch):
    """The real (non-dry-run) lifecycle against a fake gcloud that logs every
    argv and serves /proc/loadavg busy, then idle: create -> deploy ->
    run_render -> idle-terminate."""
    calls = tmp_path / "calls.log"
    counter = tmp_path / "load_calls"
    counter.write_text("0")
    fake = tmp_path / "gcloud"
    fake.write_text(f"""#!/bin/sh
echo "$@" >> {calls}
case "$@" in
  *"cat /proc/loadavg"*)
    n=$(cat {counter}); echo $((n+1)) > {counter}
    if [ "$n" -lt 2 ]; then echo "1.50 1.2 1.0 1/100 42"; else echo "0.01 0.1 0.1 1/100 42"; fi
    ;;
esac
exit 0
""")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")

    fleet = cluster.GpuFleet(cluster.ClusterConfig(name="t", workers=2), dry_run=False)
    fleet.create()
    fleet.deploy(str(tmp_path))
    fleet.run_render("gs://in", "gs://out", first=0, last=3, chunk_size=1)
    t0 = time.time()
    fleet.monitor_and_terminate(poll_s=0, idle_minutes=0.002)
    assert time.time() - t0 < 30

    logged = calls.read_text().splitlines()
    assert sum(line.startswith("compute instances create t-w0 ") for line in logged) == 1
    assert sum(line.startswith("compute instances create t-w1 ") for line in logged) == 1
    assert any("render_pipeline" in line and "--first=000000 --last=000001" in line for line in logged)
    assert any("render_pipeline" in line and "--first=000002 --last=000003" in line for line in logged)
    assert sum("cat /proc/loadavg" in line for line in logged) >= 4
    assert sum(line.startswith("compute instances delete t-w0 ") and line.endswith("--quiet") for line in logged) == 1
    assert sum(line.startswith("compute instances delete t-w1 ") for line in logged) == 1
