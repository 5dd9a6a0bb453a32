"""rgbd360_tpu — a spherical RGB-D SLAM framework in JAX.

A ground-up JAX/XLA rebuild of the capabilities of the rgbd360
reference pipeline (omnidirectional 8-sensor RGB-D acquisition, calibration,
spherical frame assembly, dense photometric+depth registration, plane-based
registration, keyframe odometry, loop closure and pose-graph SLAM).

Layer map (mirrors reference include/ layering, see SURVEY.md §1):
  io/        host-side readers/writers (.bin frames, CLAMS models, calib text)
  ops/       pure-functional jit/vmap-friendly device ops (the hot paths)
  core/      OO facade mirroring the reference public API
             (Frame360, RegisterPhotoICP, RegisterRGBD360, Map360, ...)
  parallel/  multi-device sharding (mesh helpers, batched pair registration)
  apps/      CLI applications mirroring the reference executables
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# One matmul-precision policy for the whole package. On a GPU a float32 dot
# at default precision may run in TF32 (about three decimal digits), which
# is enough noise in H = J^T J, the point transforms and the pose
# compositions to flip accept/reject decisions of the reference stopping
# rule (progress tolerance 1e-3), and to swamp metre-scale depth sums in the
# bilateral grid. Every dot the package traces is therefore full f32; on
# the CPU this is what the default already does.
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent XLA compile cache. JAX reads JAX_COMPILATION_CACHE_DIR itself
# when it is set; otherwise the cache lives at a fixed path in the checkout
# (the path is part of the cache key, so a directory that moves never hits).
CHECKOUT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)

from rgbd360_tpu.config import GlobalParams, default_params  # noqa: E402,F401
