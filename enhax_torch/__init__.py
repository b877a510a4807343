"""enhax_torch: the PyTorch/CUDA port of enhax, for NVIDIA Hopper (sm_90a).

The package mirrors ``enhax/``'s layout and names. It imports ``torch`` and
``numpy`` only; the kernels under ``kernels/csrc`` build with nvcc at first
use. Importing the package registers its models in ``MODELS``.
"""

from enhax_torch import models  # noqa: F401  (populates MODELS)
from enhax_torch.constants import MODELS, Scheme, Task
from enhax_torch.models.base import Model, build_model

__all__ = ["MODELS", "Model", "Scheme", "Task", "build_model"]
