"""Exception hierarchy (mirrors reference common/exceptions.hpp:32-77)."""


class PortFFTError(Exception):
    """Base error of the framework (reference ``base_error``)."""


class InternalError(PortFFTError):
    """Unexpected internal failure (reference ``internal_error``)."""


class InvalidConfiguration(PortFFTError):
    """The descriptor is invalid — e.g. overlapping batches, zero lengths
    (reference ``invalid_configuration``)."""


class UnsupportedConfiguration(PortFFTError):
    """The descriptor is valid but not supported by this build
    (reference ``unsupported_configuration``)."""
