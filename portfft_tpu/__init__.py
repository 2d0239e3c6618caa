"""portfft_tpu — a batched FFT framework in JAX.

From-scratch rebuild of the capabilities of portFFT
(codeplaysoftware/portFFT): a describe → commit (plan) → execute API over
JAX/XLA, with every transform level run as DFT-matrix matmuls.

Quick start::

    import portfft_tpu as pfft
    desc = pfft.Descriptor(lengths=[4096], number_of_transforms=1024)
    plan = desc.commit()
    y = plan.compute_forward(x)          # x: complex64, 4096*1024 elements
    x2 = plan.compute_backward(y)        # unnormalized inverse
"""

from . import functional
from .committed import CommittedDescriptor
from .config import DeviceConfig, resolve_device_config
from .descriptor import Descriptor
from .enums import (
    ComplexStorage,
    Direction,
    Domain,
    Layout,
    Level,
    Placement,
    inv,
)
from .exceptions import (
    InternalError,
    InvalidConfiguration,
    PortFFTError,
    UnsupportedConfiguration,
)

__all__ = [
    "CommittedDescriptor",
    "ComplexStorage",
    "Descriptor",
    "DeviceConfig",
    "Direction",
    "Domain",
    "InternalError",
    "InvalidConfiguration",
    "Layout",
    "Level",
    "Placement",
    "PortFFTError",
    "UnsupportedConfiguration",
    "functional",
    "inv",
    "resolve_device_config",
]

__version__ = "0.1.0"
