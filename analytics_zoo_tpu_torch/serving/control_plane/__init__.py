"""The serving control plane (a port of analytics_zoo_tpu/serving/
control_plane/): which model, which tenant and which priority, for every
request.

* `AdmissionCore` (admission.py): the one admission decision of every
  door: the queue bound and the SLO shedder, typed request classes
  (interactive / batch / shadow) as scheduler priorities, and per-tenant
  token-bucket quotas (`OrcaContext.tenant_quotas`) shed with 429 and
  Retry-After.
* `ModelRegistry` (registry.py): named models x versions with lifecycle
  states, registration gated on the checkpoint commit marker, and
  `hot_swap()` / `rollback()` with no in-flight request dropped.
* Routing policies (routing.py): weighted A/B between versions, and
  shadow traffic judged on the shadow side only.
"""

from analytics_zoo_tpu_torch.serving.control_plane.admission import (  # noqa: F401,E501
    CLASS_PRIORITY,
    REQUEST_CLASSES,
    AdmissionCore,
    TenantLedger,
    TokenBucket,
    get_tenant_ledger,
    reset_tenant_ledger,
)
from analytics_zoo_tpu_torch.serving.control_plane.registry import (  # noqa: F401,E501
    MODEL_STATES,
    ModelRegistry,
    ModelVersion,
)
from analytics_zoo_tpu_torch.serving.control_plane.routing import (  # noqa: F401,E501
    ShadowSampler,
    WeightedAB,
    run_shadow,
)

__all__ = [
    "AdmissionCore", "TokenBucket", "TenantLedger",
    "get_tenant_ledger", "reset_tenant_ledger",
    "REQUEST_CLASSES", "CLASS_PRIORITY",
    "ModelRegistry", "ModelVersion", "MODEL_STATES",
    "WeightedAB", "ShadowSampler", "run_shadow",
]
