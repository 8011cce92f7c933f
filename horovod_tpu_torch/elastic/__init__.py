"""The port's elastic layer, so far the launch rank that fault injection
keys on (:mod:`~horovod_tpu_torch.elastic.fault_inject`), which the
checkpoint writer's commit-phase faults use. The runner, the driver,
``State``, its per-step faults and the re-form come with the launcher's
rendezvous store (ROADMAP, elastic)."""
