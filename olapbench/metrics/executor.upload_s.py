"""Sum of the program's ``upload`` spans (s): each table's host padding,
copies to the card, int32 shadow copies and dense key index, once, when the
first query that reads it runs in set-up (``DeviceExecutor._device_tables``).
Read from the program's process-wide registry, where the span records
whether or not its recorder is open.  None where the program has no such
span."""


def read(run):
    from gpu_olap_tpu_torch.utils.metrics import GLOBAL_METRICS

    st = GLOBAL_METRICS.ops.get("upload")
    return st.seconds if st is not None and st.calls else None
