"""The port's public surface against the JAX package's, read with ``ast``
(neither package is imported).

Every public function, class and method of ``facebook360_dep_tpu/`` (a
name without a leading underscore, and ``__init__``) must have a
counterpart of the same name in the port's module of the same path, and
the counterpart must take every parameter the JAX one takes. Methods a
class inherits from a base class of its module count as its own. Every
CLI must define the same ``add_argument`` flags and subcommands as the JAX
CLI of its name.

``ALLOWED`` lists the differences that are not faults, each with its
reason: a name (``module::name``) or a parameter (``module::name(param)``)
the port lacks on purpose. ``RENAMED`` maps a class to its port under
another name, whose methods are then checked. An entry that no longer
names a gap fails the test too, so the list cannot grow stale.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "facebook360_dep_tpu")
PORT_PKG = os.path.join(ROOT, "facebook360_dep_tpu_torch")

_A12 = "TPU-only sampler semantics (per-tile source windows, quantization, the sampler toggle): ROADMAP A12"
_UNREAD = "the JAX function takes it and never reads it"
_KEY = "a JAX PRNG key; the port draws from a torch.Generator (generator=) or takes the draws (uniforms=)"
_AS_NUMPY = "JAX idiom: converts the JAX result to numpy; the port returns tensors (.cpu().numpy())"
_DTYPE = ("JAX idiom: the dtype of the JAX arrays built; the port builds float64 host tensors and casts with "
          "Camera.to(dtype=)")
_DEVICES = "a list of JAX devices; the port's meshes span the ranks of the torch.distributed group"

ALLOWED = {
    "ops/warp_pallas.py": "the Pallas TPU kernels, ported as ops/warp_cuda.py and csrc/*.cu (K1-K4)",
    "utils/__init__.py": "the package of utils/hostmath.py",
    "utils/hostmath.py": "pins the JAX package's host math to JAX's CPU backend; the port has no JAX",
    "ops/cost.py::auto_window": _A12,
    "ops/cost.py::quantize_src": _A12,
    "ops/cost.py::stack_dtype": _A12,
    "ops/cost.py::cost_for_disparity(window)": _A12,
    "ops/cost.py::brute_force_disparity(window)": _A12,
    "depth/solver.py::make_level_context(use_pallas_sampler)": _A12,
    "depth/solver.py::make_level_context(src_fg_masks)": _UNREAD,
    "cli/convert_to_binary.py::convert_depth(save_obj)": _UNREAD,
    "cli/compute_rephotography_errors.py::load_rig_images(size_wh)": _UNREAD,
    "depth/solver.py::random_proposals(key)": _KEY,
    "depth/solver.py::process_level(key)": _KEY,
    "parallel/sharding.py::process_level_sharded(key)": _KEY,
    "parallel/sharding.py::process_frames_sharded(key)": _KEY,
    "depth/solver.py::process_level(debug_sync)": ("bisects JAX's one jitted program a level into per-stage "
                                                   "programs; the port runs its stages eagerly"),
    "parallel/sharding.py::camera_mesh(devices)": _DEVICES,
    "parallel/sharding.py::frame_camera_mesh(devices)": _DEVICES,
    "render/raytrace.py::render_mesh_scene(as_numpy)": _AS_NUMPY,
    "render/synthetic.py::render_sphere_scene(as_numpy)": _AS_NUMPY,
    "render/synthetic.py::render_box_scene(as_numpy)": _AS_NUMPY,
    "core/camera.py::make_camera(dtype)": _DTYPE,
    "core/camera.py::camera_from_json(dtype)": _DTYPE,
    "core/camera.py::load_rig_from_json_str(dtype)": _DTYPE,
    "core/camera.py::load_rig(dtype)": _DTYPE,
    "cli/convert_to_binary.py::jax_free_camera": ("JAX idiom: a camera as a numpy pytree, to pickle for a process "
                                                  "pool; the port's conversion tasks run on threads"),
    "cli/convert_to_binary.py::convert_one(argd)": ("JAX idiom: the flags as a dict, to pickle for a process pool; "
                                                    "the port's tasks on threads take the Namespace (args)"),
    "cli/simple_mesh_renderer.py::load_frame": ("the JAX package's copy of compute_rephotography_errors."
                                                "load_rig_images, which the port's renderer imports"),
}
RENAMED = {"farm/cluster.py::TpuFleet": "GpuFleet"}  # the fleet of single-GPU workers


def _params(fn: ast.FunctionDef) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [f"*{a.vararg.arg}"] if a.vararg else []
    names += [f"**{a.kwarg.arg}"] if a.kwarg else []
    return [n for n in names if n not in ("self", "cls")]


def _public(path: str) -> dict:
    """{name or Class.method: its parameters (None for a class)} of a module."""
    with open(path) as f:
        tree = ast.parse(f.read())
    classes = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}

    def methods(cls: ast.ClassDef) -> dict:
        out = {}
        for base in cls.bases:  # a base class of the same module first, so the class's own override
            if isinstance(base, ast.Name) and base.id in classes:
                out.update(methods(classes[base.id]))
        for sub in cls.body:
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                    not sub.name.startswith("_") or sub.name == "__init__"):
                out[sub.name] = _params(sub)
        return out

    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and not node.name.startswith("_"):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out[node.name] = None
            out.update({f"{node.name}.{m}": p for m, p in methods(node).items()})
    return out


def _modules() -> list:
    mods = []
    for root, _, files in os.walk(JAX_PKG):
        mods += [os.path.relpath(os.path.join(root, f), JAX_PKG) for f in files if f.endswith(".py")]
    return sorted(mods)


def _gaps(rel: str) -> set:
    """The keys of every difference in module ``rel``: ``rel`` itself if the
    port has no such module, else ``rel::name`` and ``rel::name(param)``."""
    port_path = os.path.join(PORT_PKG, rel)
    if not os.path.exists(port_path):
        return {rel}
    jax_names, port_names = _public(os.path.join(JAX_PKG, rel)), _public(port_path)
    gaps = set()
    for name, params in jax_names.items():
        cls, dot, method = name.partition(".")
        port_name = RENAMED.get(f"{rel}::{cls}", cls) + dot + method
        if port_name not in port_names:
            gaps.add(f"{rel}::{name}")
            continue
        gaps.update(f"{rel}::{name}({p})" for p in params or () if p not in port_names[port_name])
    return gaps


@pytest.mark.parametrize("rel", _modules())
def test_every_public_name_and_parameter_has_a_port(rel):
    missing = sorted(g for g in _gaps(rel) if g not in ALLOWED)
    assert not missing, f"the port lacks (add it, or an ALLOWED entry with its reason): {missing}"


def test_allow_list_names_only_real_gaps():
    gaps = set().union(*(_gaps(rel) for rel in _modules()))
    stale = sorted(k for k in ALLOWED if k not in gaps)
    assert not stale, f"ALLOWED entries the port no longer lacks: {stale}"
    for key, reason in ALLOWED.items():
        assert len(reason) > 20, key
    for key in RENAMED:
        rel, cls = key.split("::")
        assert cls in _public(os.path.join(JAX_PKG, rel)) and RENAMED[key] in _public(os.path.join(PORT_PKG, rel))


def _cli_surface(path: str) -> set:
    """Every option string of ``add_argument`` and every ``add_parser`` name."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            strings = [a.value for a in node.args if isinstance(a, ast.Constant) and isinstance(a.value, str)]
            if node.func.attr == "add_argument":
                out.update(s for s in strings if s.startswith("-"))
            elif node.func.attr == "add_parser":
                out.update(f"subcommand {s}" for s in strings[:1])
    return out


CLIS = sorted(f for f in os.listdir(os.path.join(JAX_PKG, "cli")) if f.endswith(".py") and f != "__init__.py")


@pytest.mark.parametrize("cli", CLIS)
def test_cli_flags_match(cli):
    want = _cli_surface(os.path.join(JAX_PKG, "cli", cli))
    got = _cli_surface(os.path.join(PORT_PKG, "cli", cli))
    assert want, f"{cli}: no flags read"
    assert got == want, f"{cli}: the port lacks {sorted(want - got)}, adds {sorted(got - want)}"
