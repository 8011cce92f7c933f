"""The launcher side of the port, so far the rendezvous store that the
elastic layer re-forms through (:mod:`.rendezvous`). The launcher itself
(``tpurun``'s flags, host lists, ssh) is ROADMAP A13."""
