"""repro_torch.sched — the SWIFT scheduler (port of ``repro/sched``): the
cost model and fleet (``costmodel``), the model DAG (``graph``), the
double DQN (``dqn``), the two-phase scheduler (``swift``), the
availability clustering (``clustering``), the DTMC mobility model
(``mobility``, which drives the async engine's pod migrations) and the
dwell-time WDR regressor (``dwell``)."""
