"""flowsim_tpu_torch — the PyTorch/CUDA port of flowsim_tpu.

Same module layout as the JAX package (``geometry``, ``ops.sections``,
``ops.preissmann``, ``api``, ``models.gerd_roseires`` ...) so a reader finds
each counterpart; tensors instead of pytrees, float64 throughout, and the
Pallas TPU kernels replaced by hand-written CUDA kernels for Hopper under
``ops/cuda``.  Importing the package needs neither ``nvcc`` nor a GPU: the
kernels are compiled at first use.
"""

from flowsim_tpu_torch.config import GRAVITY, default_dtype, resolve_device
from flowsim_tpu_torch.geometry import (
    TableGeometry,
    TrapezoidGeometry,
    TrapezoidStation,
    build_trapezoid_geometry,
    interpolate_stations,
    trapezoid_station,
)
from flowsim_tpu_torch.geometry_tables import IrregularStation, build_table_geometry
from flowsim_tpu_torch.api import (
    Boundary,
    Channel,
    Hydrograph,
    PreissmannSolver,
    RatingCurve,
)

__version__ = "0.1.0"
