"""The port's multi-GPU solve (facebook360_dep_tpu_torch/parallel/sharding.py)
in 1, 2 and 4 gloo processes on the CPU, against the port's single-process
``process_level`` (bit for bit) and the JAX package's sharded solves on the
conftest's 8-device CPU mesh (the XLA path).

The scene is 8 cameras at 32x24 around a textured sphere, solved at level 1
of 3 from an init 1.5x the truth with a block of camera 1 at 1.8x that: the
random proposals, ping-pong and the mismatch stage all change pixels there
(var_high_thresh 1e-2 lets the mismatch stage replace textured pixels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facebook360_dep_tpu.core import camera as jcam
from facebook360_dep_tpu.depth import pipeline as jpipe
from facebook360_dep_tpu.depth import solver as js
from facebook360_dep_tpu.parallel import sharding as jsh
from facebook360_dep_tpu.render import synthetic as jsyn
from facebook360_dep_tpu_torch.core import camera as tcam
from facebook360_dep_tpu_torch.depth import pipeline as tpipe
from facebook360_dep_tpu_torch.depth import solver as ts
from facebook360_dep_tpu_torch.ops import warp_cuda as wc

from torch_parity import f32, port_rig, tt
from torch_ranks import finish, kill, start

W, H, D = 32, 24, 8
VAR_HIGH = 1e-2
BASE = dict(min_depth=1.0, max_depth=100.0, level=1, num_levels=3, ping_pong_iterations=1,
            mismatches_start_level=1)
CFG = dict(BASE, num_random_proposals=2)
CFG0 = dict(BASE, num_random_proposals=0)
FRAME_CFG0 = dict(CFG0, level=0)
# the TPU sampler's semantics (use_pallas_sampler=True) with windows of 8 rows, which clip
TPU_CFG = dict(CFG, ww_max=128, wh_max=8)
TPU = dict(use_pallas_sampler=True)
DST_FIELDS = ("dst_planar", "dst_variance", "dst_fov_masks", "dst_fg_masks", "dst_bg_disp", "dst_rays")


def bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits (NaN equal to NaN), for torch.equal."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def same_bits(a: dict, b: dict) -> bool:
    return all(torch.equal(bits(a[k]), bits(b[k])) for k in ("disparity", "cost", "confidence", "mismatches"))


def jax_shard_draws(key, n_dev: int, p: int) -> np.ndarray:
    """The (D, P, H, W) draws of JAX's process_level_sharded on an
    ``n_dev`` mesh: the key is replicated, so each shard splits it over its
    own D / n_dev destinations (solver.py:248-249, 243, 232)."""
    local = [[np.asarray(jax.random.uniform(kk, (H, W), jnp.float32)) for kk in jax.random.split(k, p)]
             for k in jax.random.split(key, D // n_dev)]
    return f32([local[g % (D // n_dev)] for g in range(D)])


@pytest.fixture(scope="module")
def scene():
    rig = jcam.normalize_rig(jsyn.make_test_rig(num_cameras=D, resolution=(W, H), ring_radius=0.3))
    colors, gt = jsyn.render_sphere_scene(jsyn.make_test_rig(num_cameras=D, resolution=(W, H), ring_radius=0.3),
                                          (W, H), radius=5.0)
    colors = np.array(colors, np.float32)  # writable, as torch.from_numpy wants
    init = f32(gt) * np.float32(1.5)
    init[1, 8:16, 10:20] *= np.float32(1.8)
    frames = np.stack([colors, f32(colors * np.float32(0.9) + np.float32(0.05))])
    trig = port_rig(tcam, rig)
    tctx = ts.make_level_context(trig, trig, tt(colors), tpipe.generate_fov_masks(trig, (H, W)),
                                 var_high_thresh=VAR_HIGH)
    jctx = js.make_level_context(rig, rig, colors, jpipe.generate_fov_masks(rig, (H, W)),
                                 var_high_thresh=VAR_HIGH, use_pallas_sampler=False)
    return dict(rig=rig, trig=trig, colors=colors, init=init, frames=frames, tctx=tctx, jctx=jctx)


@pytest.fixture(scope="module")
def started(scene, tmp_path_factory):
    """The port's sharded solves by world size, started: default draws
    (``level``), no proposals (``level0``), the draws of JAX's 8 shards and
    of its one device, and each rank on its own block of the level's
    context (``block``); at 4 ranks also two frames on a 2 x 2 mesh (from
    the whole context, and from each rank's block), the TPU sampler's
    semantics on the blocks (``tpu_block``, ``tpu_frames``) and 6
    destinations over 4 ranks."""
    init = torch.from_numpy(scene["init"])
    key = jax.random.PRNGKey(1)
    tasks = {
        "level": dict(kind="level", cfg=CFG, init=init),
        "level0": dict(kind="level", cfg=CFG0, init=init),
        "jax_draws": dict(kind="level", cfg=CFG, init=init, uniforms=torch.from_numpy(jax_shard_draws(key, 8, 2))),
        "jax_single_draws": dict(kind="level", cfg=CFG, init=init,
                                 uniforms=torch.from_numpy(jax_shard_draws(key, 1, 2))),
        "block": dict(kind="level", cfg=CFG, init=init, block=True),
    }
    frames, inits = torch.from_numpy(scene["frames"]), torch.stack([init, init])
    frame_tasks = {
        "frames": dict(kind="frames", frame_axis=2, cfg=dict(CFG, level=0), frames=frames, init=inits),
        "frames0": dict(kind="frames", frame_axis=2, cfg=FRAME_CFG0, frames=frames, init=inits),
        "frames_block": dict(kind="frames", frame_axis=2, cfg=dict(CFG, level=0), frames=frames, init=inits,
                             block=True),
        "tpu_block": dict(kind="level", cfg=TPU_CFG, init=init, block=True, context=TPU),
        "tpu_frames": dict(kind="frames", frame_axis=2, cfg=dict(TPU_CFG, level=0), frames=frames, init=inits,
                           block=True, context=TPU),
        "indivisible": dict(kind="indivisible", cfg=CFG, destinations=6),
    }
    job = dict(kind="solve", rig=scene["trig"], colors=torch.from_numpy(scene["colors"]),
               context=dict(var_high_thresh=VAR_HIGH))
    procs = start(tmp_path_factory.mktemp("sharding"),
                  {world: (world, dict(job, tasks=dict(tasks, **(frame_tasks if world == 4 else {}))))
                   for world in (1, 2, 4)})
    yield procs
    kill(procs)


@pytest.fixture(scope="module")
def runs(started):
    """``started``'s gathered results, by world size."""
    return finish(started)


@pytest.fixture(scope="module")
def single(scene):
    return ts.process_level(scene["tctx"], ts.SolverConfig(**CFG), init_disparity=tt(scene["init"]))


@pytest.fixture(scope="module")
def jax_level0(scene):
    return jsh.process_level_sharded(scene["jctx"], js.SolverConfig(**CFG0), jsh.camera_mesh(jax.devices()[:8]),
                                     init_disparity=scene["init"])


@pytest.fixture(scope="module")
def jax_sharded_proposals(scene):
    return jsh.process_level_sharded(scene["jctx"], js.SolverConfig(**CFG), jsh.camera_mesh(jax.devices()[:8]),
                                     init_disparity=scene["init"])


def _close_to_jax(port: dict, jout) -> None:
    """The JAX sharded test's contract (tests/test_sharding.py:64-66):
    the same finite pixels, and the disparity there within 1e-5."""
    a, b = np.asarray(jout["disparity"]), port["disparity"].numpy()
    assert (np.isfinite(a) == np.isfinite(b)).all()
    mask = np.isfinite(a)
    np.testing.assert_allclose(b[mask], a[mask], atol=1e-5)


def test_matches_jax_sharded_without_proposals(started, jax_level0, runs):
    """The port's sharded solve at 1, 2 and 4 ranks against JAX's on 8
    devices, no proposals (tests/test_sharding.py:39-42). The fixtures'
    order lets the ranks run while JAX compiles."""
    for world in (1, 2, 4):
        _close_to_jax(runs[world][0]["level0"], jax_level0)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_equals_single_process(scene, runs, single, world):
    """Every rank gathers the level's maps equal to process_level's bit for
    bit, though the draws matter (another seed moves pixels) and the
    mismatch stage replaces pixels."""
    for rank, saved in enumerate(runs[world]):
        assert saved["level_destinations"] == tuple(range(rank * D // world, (rank + 1) * D // world))
        assert same_bits(saved["level"], single), (world, rank)
    assert single["mismatches"].sum() > 20
    other = ts.process_level(scene["tctx"], ts.SolverConfig(**CFG), init_disparity=tt(scene["init"]),
                             generator=torch.Generator().manual_seed(99))
    differ = (other["disparity"] != single["disparity"]) & ~single["disparity"].isnan()
    assert differ.double().mean() > 0.05


def test_matches_jax_sharded_with_its_shards_draws(runs, jax_sharded_proposals):
    """Fed the draws each JAX shard makes, the port's sharded solve lands
    on JAX's at every world size."""
    for world in (1, 2, 4):
        _close_to_jax(runs[world][0]["jax_draws"], jax_sharded_proposals)


def test_jax_sharded_draws_depend_on_the_mesh(runs, single, jax_sharded_proposals):
    """The JAX fault (ROADMAP queue C): its replicated key gives destination
    j of every shard the same draws, so with accepted proposals its sharded
    result depends on the mesh. The port fed JAX's one-device draws (those
    of JAX's process_level, solver.py:248-249; tests/test_torch_solver.py
    holds the port to it with them) parts from JAX's 8-shard result on a
    share of pixels, where fed the 8 shards' draws it lands on it
    (test_matches_jax_sharded_with_its_shards_draws); the port's own
    sharded result is the same at 1, 2 and 4 ranks."""
    one_device = runs[1][0]["jax_single_draws"]["disparity"].numpy()
    sharded = np.asarray(jax_sharded_proposals["disparity"])
    fin = np.isfinite(sharded)
    diff = np.abs(one_device[fin] - sharded[fin])
    assert (diff > 1e-5).mean() > 0.01 and diff.max() > 0.01, ((diff > 1e-5).mean(), diff.max())
    assert all(same_bits(runs[w][0]["level"], single) for w in (1, 2, 4))


def test_frames_sharded_equal_process_level_per_frame(scene, runs):
    """2 frames x 2 camera ranks: each frame's maps equal process_level on
    that frame's own context (its own destination colors and variance)."""
    fov = tpipe.generate_fov_masks(scene["trig"], (H, W))
    want = [ts.process_level(ts.make_level_context(scene["trig"], scene["trig"], tt(frame), fov,
                                                   var_high_thresh=VAR_HIGH),
                             ts.SolverConfig(**dict(CFG, level=0)), init_disparity=tt(scene["init"]))
            for frame in scene["frames"]]
    assert not torch.equal(want[0]["disparity"].nan_to_num(), want[1]["disparity"].nan_to_num())
    for rank, saved in enumerate(runs[4]):
        assert saved["frames_frames"] == ((0,) if rank < 2 else (1,))
        for f in range(2):
            assert same_bits({k: v[f] for k, v in saved["frames"].items()}, want[f]), (rank, f)


def test_frames_sharded_match_jax(scene, runs):
    mesh = jsh.frame_camera_mesh(jax.devices()[:8], frame_axis=2)
    jout = jsh.process_frames_sharded(scene["jctx"], scene["frames"], js.SolverConfig(**FRAME_CFG0), mesh,
                                      init_disparity=np.stack([scene["init"]] * 2))
    port = runs[4][0]["frames0"]
    for f in range(2):
        _close_to_jax({"disparity": port["disparity"][f]}, {"disparity": np.asarray(jout["disparity"])[f]})


def test_with_images_replaces_every_image_field(scene):
    """A frame's context (solver.with_images) equals make_level_context on
    that frame's colors in every field, the destinations' colors and
    variance included: frame 0's would solve frame 1 against frame 0."""
    fov = tpipe.generate_fov_masks(scene["trig"], (H, W))
    base = ts.make_level_context(scene["trig"], scene["trig"], tt(scene["frames"][0]), fov)
    want = ts.make_level_context(scene["trig"], scene["trig"], tt(scene["frames"][1]), fov)
    got = ts.with_images(base, tt(scene["frames"][1]))
    for name in ts.LevelContext._fields:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(bits(a), bits(b)), name
        elif name not in ("src_cams", "dst_cams"):
            assert a == b, name
    for name in ("src_imgs", "src_rgba", "src_variance", "dst_planar", "dst_variance"):
        assert not torch.equal(getattr(got, name), getattr(base, name)), name
    # a selection of destinations keeps its own colors
    sub = ts.with_images(ts.select_destinations(base, [5, 2]), tt(scene["frames"][1]))
    assert torch.equal(sub.dst_planar, want.dst_planar[[5, 2]])
    assert torch.equal(sub.dst_variance, want.dst_variance[[5, 2]])


def test_destinations_not_divisible_by_the_ranks_raise(runs):
    """As JAX asserts (sharding.py:57-59, 123-124): 6 destinations over 4
    camera ranks, and 4 ranks in 3 frame groups."""
    for saved in runs[4]:
        assert "6 items along 'cam' not divisible by its 4 ranks" in saved["indivisible"]
        assert "4 ranks do not split into 3 frame groups" in saved["indivisible_frames"]


def _frame_references(scene, cfg, **context):
    """process_level on each frame's own context."""
    fov = tpipe.generate_fov_masks(scene["trig"], (H, W))
    return [ts.process_level(ts.make_level_context(scene["trig"], scene["trig"], tt(frame), fov,
                                                   var_high_thresh=VAR_HIGH, **context),
                             ts.SolverConfig(**cfg), init_disparity=tt(scene["init"]))
            for frame in scene["frames"]]


@pytest.mark.parametrize("world", [2, 4])
def test_block_contexts_hold_only_their_destinations(runs, single, world):
    """A rank's context (make_level_context(destinations=its block)) holds
    its block's destination fields only, with dst2src into the full source
    list; the rank keeps the (D / ranks, P, H, W) draws of its block; the
    maps equal process_level's bit for bit."""
    k = D // world
    for rank, saved in enumerate(runs[world]):
        fields = saved["block_fields"]
        assert fields["dst_index"] == tuple(range(rank * k, (rank + 1) * k)) == fields["dst2src"]
        assert fields["dst_planar"] == (k, 3, H, W) and fields["dst_rays"] == (k, 3, H, W)
        assert all(fields[f] == (k, H, W) for f in ("dst_variance", "dst_fov_masks", "dst_fg_masks", "dst_bg_disp"))
        assert saved["block_draws"] == [(k, 2, H, W)]
        assert saved["level_draws"] == [(k, 2, H, W)]  # from the whole context: the block's draws only too
        assert same_bits(saved["block"], single), (world, rank)


def test_draws_keep_one_block():
    """draw_uniforms(keep=) returns the kept destinations' draws of the
    whole level's, whichever block is kept."""
    full = ts.draw_uniforms(torch.Generator().manual_seed(7), 8, 2, 5, 6)
    for keep in (range(0, 2), range(4, 8), range(3, 4)):
        got = ts.draw_uniforms(torch.Generator().manual_seed(7), 8, 2, 5, 6, keep=keep)
        assert torch.equal(got, full[keep.start:keep.stop])


def test_frames_from_blocks_equal_process_level_per_frame(scene, runs):
    """2 frames x 2 camera ranks on each rank's block, in the default and
    the TPU sampler's semantics: each frame's maps equal process_level on
    that frame's own context; the TPU semantics solve differently."""
    want = _frame_references(scene, dict(CFG, level=0))
    want_tpu = _frame_references(scene, dict(TPU_CFG, level=0), **TPU)
    assert not torch.equal(want[0]["disparity"].nan_to_num(), want_tpu[0]["disparity"].nan_to_num())
    for rank, saved in enumerate(runs[4]):
        assert saved["frames_block_frames"] == saved["tpu_frames_frames"] == ((0,) if rank < 2 else (1,))
        assert saved["tpu_frames_fields"]["dst_planar"] == (4, 3, H, W)
        for f in range(2):
            assert same_bits({k: v[f] for k, v in saved["frames_block"].items()}, want[f]), (rank, f)
            assert same_bits({k: v[f] for k, v in saved["tpu_frames"].items()}, want_tpu[f]), (rank, f)


def test_tpu_mode_sharded_equals_process_level(scene, runs):
    """The TPU sampler's semantics on 4 ranks' blocks (windows that clip,
    the mismatch stage's TPU-mode branch included) equal process_level on
    one process bit for bit."""
    ctx = ts.make_level_context(scene["trig"], scene["trig"], tt(scene["colors"]),
                                tpipe.generate_fov_masks(scene["trig"], (H, W)), var_high_thresh=VAR_HIGH, **TPU)
    want = ts.process_level(ctx, ts.SolverConfig(**TPU_CFG), init_disparity=tt(scene["init"]))
    cctx = ts.cost_context(ctx)
    _, _, clipped = wc.project_sample_tpu(cctx.src_tpu, cctx.src_params, cctx.cam_dst.position, tt(scene["init"]),
                                          cctx.dst_rays, wc.tile_windows(cctx.src_params, cctx.cam_dst.position,
                                                                         tt(scene["init"]), cctx.dst_rays, (H, W),
                                                                         (128, 8)), (128, 8))
    assert clipped.any()
    for rank, saved in enumerate(runs[4]):
        assert saved["tpu_block_fields"]["dst_index"] == tuple(range(2 * rank, 2 * rank + 2))
        assert same_bits(saved["tpu_block"], want), rank
