"""Sum of the program's ``register`` spans (s): Arrow decode, re-encode
and statistics of every table set-up hands to ``TorchOlapEngine.register``.
Read from the program's process-wide registry, where the span records
whether or not its recorder is open; a run's process registers tables in
set-up only.  None where the program has no such span."""


def read(run):
    from gpu_olap_tpu_torch.utils.metrics import GLOBAL_METRICS

    st = GLOBAL_METRICS.ops.get("register")
    return st.seconds if st is not None and st.calls else None
