"""repro_torch.api — the Session, Strategy and mesh layer of the port
(port of ``repro.api``): ``Session(...).run`` runs the step strategies
(``pipeline``, FHDP, and ``tensor``) and the round strategies
(``fl_pipeline``, ``hier_fl`` and its base ``fedavg``, ``distill_fl``)
on one device, and ``Session(...).serve`` serves the model with the
legacy or the continuous scheduler."""
from repro_torch.api.mesh import Mesh, MeshSpec  # noqa: F401
from repro_torch.api.session import (Session, load_config,  # noqa: F401
                                     resolve_shape)
from repro_torch.api.strategies import (Strategy,  # noqa: F401
                                        available_strategies, get_strategy,
                                        register_strategy)
from repro_torch.train.loop import LoopHooks  # noqa: F401
