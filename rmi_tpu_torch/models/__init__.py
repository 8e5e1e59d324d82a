"""Model registry of the port.  Importing this package registers
``linear``, ``robust_linear``, ``loglinear``, ``linear_spline``,
``cubic``, ``normal`` and ``lognormal``, each as a top or a leaf model;
every other model the reference knows raises NotImplementedError that
names the ROADMAP queue holding it (models/base.py)."""

from rmi_tpu_torch.models.base import (ModelDef, REGISTRY, get_model,
                                       predict_clamped, validate_spec)
from rmi_tpu_torch.models import linear as _linear  # noqa: F401
from rmi_tpu_torch.models import cubic as _cubic    # noqa: F401
from rmi_tpu_torch.models import normal as _normal  # noqa: F401

__all__ = ["ModelDef", "REGISTRY", "get_model", "predict_clamped",
           "validate_spec"]
