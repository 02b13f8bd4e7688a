"""The port's copy of the framework error base of ``polyaxon_tpu/exceptions.py``."""


class PolyaxonTPUError(Exception):
    """Base class for all framework errors."""
