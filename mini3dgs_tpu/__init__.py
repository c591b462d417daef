"""mini3dgs_tpu: a differentiable 3D Gaussian Splatting framework in JAX.

Brand-new JAX/XLA/Pallas implementation with the capability surface of
`Loveof1ife7/mini-3d-gaussian-splatting` (see SURVEY.md): functional pytrees,
static-shape slot pools, Pallas (Triton) raster kernels with a hand-written
VJP, and shard_map-based tile/data parallelism.  Runs on an NVIDIA GPU; the
CPU runs the same code with the kernels interpreted (tests).
"""

__version__ = "0.1.0"

from .config import ConfigManager, TrainingConfig
from .core.camera import Camera
from .core.gaussians import Gaussians, create_from_pcd, create_from_random
from .ops.renderer import RenderSettings, render
