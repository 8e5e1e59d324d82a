"""Model registry of the port.  Importing this package registers all of
the reference's model types (train/mod.rs:35-57): ``linear``,
``robust_linear``, ``loglinear``, ``linear_spline``, ``cubic``,
``normal``, ``lognormal`` and the hint tables ``radix8/18/22/26/28`` as
top or leaf, and ``radix``, ``bradix`` and ``histogram`` as top."""

from rmi_tpu_torch.models.base import (ModelDef, REGISTRY, Restriction,
                                       clamp_int, get_model, predict_clamped,
                                       validate_spec)
from rmi_tpu_torch.models import linear as _linear  # noqa: F401
from rmi_tpu_torch.models import cubic as _cubic    # noqa: F401
from rmi_tpu_torch.models import normal as _normal  # noqa: F401
from rmi_tpu_torch.models import radix as _radix    # noqa: F401
from rmi_tpu_torch.models import histogram as _histogram  # noqa: F401

__all__ = ["ModelDef", "REGISTRY", "Restriction", "clamp_int", "get_model",
           "predict_clamped", "validate_spec"]
