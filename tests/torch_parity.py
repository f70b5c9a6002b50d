"""Shared helpers of the tests that hold the PyTorch port against the JAX package.

Inputs are made with numpy from a seed and cast to float32 on both sides
(tests/conftest.py turns on JAX x64, so a float64 array would run the
reference in float64). Tier-1 runs several pytest workers, so each test
process keeps torch to two threads.
"""

import numpy as np
import torch

torch.set_num_threads(2)

TYPES = ["FTHETA", "RECTILINEAR", "EQUISOLID", "ORTHOGRAPHIC"]
# nonzero radial distortion per camera type, within each model's monotone range
DISTORTION = {
    "FTHETA": (-0.03413328161902581, 0.0004374554953464843, -0.0018843963208481174),
    "RECTILINEAR": (-0.05, 0.004, 0.0),
    "EQUISOLID": (0.03, -0.01, 0.0),
    "ORTHOGRAPHIC": (-0.04, 0.002, 0.0),
}


def f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def tt(x) -> torch.Tensor:
    """numpy (or JAX) array -> float32 torch tensor (bool/int arrays keep their type)."""
    a = np.asarray(x)
    return torch.from_numpy(np.array(a, np.float32 if a.dtype.kind == "f" else a.dtype))


def rel_err(got, want) -> np.ndarray:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want) / (1.0 + np.abs(want))


def ring_rig(jcam, type_name: str, n: int = 4, resolution=(48, 36), ring_radius=0.15, distorted=True,
             mixed=False):
    """A forward-looking ring rig of the JAX package's cameras (float64);
    ``mixed`` cycles the four camera types."""
    w, h = resolution
    cams, ids = [], []
    for i in range(n):
        a = 2 * np.pi * i / n
        tname = TYPES[i % 4] if mixed else type_name
        cams.append(jcam.make_camera(
            type_code=getattr(jcam, tname),
            position=[ring_radius * np.cos(a), ring_radius * np.sin(a), 0.0],
            rotation=np.eye(3),
            resolution=[w, h],
            focal=[0.45 * w, -0.45 * w],
            distortion=DISTORTION[tname] if distorted else (0.0, 0.0, 0.0),
        ))
        ids.append(f"cam{i}")
    return jcam.Rig(cameras=jcam.stack_cameras(cams), ids=tuple(ids), groups=("",) * n)


def port_rig(tcam, jrig):
    """The same rig as the port's float64 cameras."""
    return tcam.Rig(tcam.camera_from_numpy(jrig.cameras), jrig.ids, jrig.groups)


def jax_f32(tree):
    """A JAX camera pytree with its float leaves cast to float32."""
    import jax
    import jax.numpy as jnp

    return jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float32) if np.asarray(a).dtype.kind == "f" else jnp.asarray(a), tree)
