"""The serving layer's tenant configuration (port of
``factormodeling_tpu/serve/tenant.py``). The batched step, the front end,
the queue and admission are not ported yet."""

from factormodeling_tpu_torch.serve.tenant import (TenantConfig,
                                                    stack_configs)

__all__ = ["TenantConfig", "stack_configs"]
