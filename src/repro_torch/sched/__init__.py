"""repro_torch.sched — the SWIFT scheduler (port of ``repro/sched``): the
cost model and fleet (``costmodel``), the model DAG (``graph``), the
double DQN (``dqn``), the two-phase scheduler (``swift``) and the
availability clustering (``clustering``). The dwell-time GRU and the
mobility model come with the async FL slice."""
