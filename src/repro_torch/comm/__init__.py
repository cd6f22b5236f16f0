"""repro_torch.comm — the vehicle -> edge -> cloud fabric of the port:
:class:`~repro_torch.comm.topology.Topology`, the update codecs with
error feedback (:mod:`~repro_torch.comm.codecs`), the two-tier
aggregation and the ``hier_fl`` round with its event-time halves
(:mod:`~repro_torch.comm.hierarchy`), and the discrete-event engine of
``async_hier_fl`` (:mod:`~repro_torch.comm.events`), whose queue the
serving load generator runs on too."""
from repro_torch.comm.codecs import (Codec, GeneratorBits,  # noqa: F401
                                     IdentityCodec, Int8Codec, TopKCodec,
                                     available_codecs, get_codec)
from repro_torch.comm.events import (AsyncHierFLEngine,  # noqa: F401
                                     ComputeModel, EventQueue,
                                     FleetMobility, HierFLProgram,
                                     MobilitySpec, simulate_schedule)
from repro_torch.comm.hierarchy import (cloud_merge,  # noqa: F401
                                        cloud_merge_at, edge_aggregate,
                                        edge_commit, hierarchical_mean,
                                        make_hier_round, pod_broadcast,
                                        pod_slice, staleness_weights)
from repro_torch.comm.topology import Topology, parse_topology  # noqa: F401
