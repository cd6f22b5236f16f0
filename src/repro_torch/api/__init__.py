"""repro_torch.api — the Session and Strategy layer of the port (port of
``repro.api``): ``Session(...).run`` runs round strategies (``hier_fl``
and its base ``fedavg``) and ``distill_fl`` on one device, and
``Session(...).serve`` serves the model with the legacy or the
continuous scheduler."""
from repro_torch.api.session import (Session, load_config,  # noqa: F401
                                     resolve_shape)
from repro_torch.api.strategies import (Strategy,  # noqa: F401
                                        available_strategies, get_strategy,
                                        register_strategy)
from repro_torch.train.loop import LoopHooks  # noqa: F401
