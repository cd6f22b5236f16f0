"""repro_torch.comm — the vehicle -> edge -> cloud fabric of the port:
:class:`~repro_torch.comm.topology.Topology`, the update codecs with
error feedback (:mod:`~repro_torch.comm.codecs`), the two-tier
aggregation and the ``hier_fl`` round (:mod:`~repro_torch.comm
.hierarchy`), and the event queue the serving load generator runs on.
The event-driven async FL engine is not ported yet."""
from repro_torch.comm.codecs import (Codec, GeneratorBits,  # noqa: F401
                                     IdentityCodec, Int8Codec, TopKCodec,
                                     available_codecs, get_codec)
from repro_torch.comm.hierarchy import (cloud_merge,  # noqa: F401
                                        edge_aggregate, hierarchical_mean,
                                        make_hier_round, pod_broadcast,
                                        pod_slice, staleness_weights)
from repro_torch.comm.topology import Topology, parse_topology  # noqa: F401
