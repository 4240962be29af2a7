"""decode_attention_roofline: the least time of the traced batch's decode
attention calls (FLOPs and bytes counted from their shapes) over the
device time of the decode kernels (split and merge) in the trace."""
from portbench import count

KERNELS = ("decode_split_kernel", "decode_merge_kernel")


def read(run):
    tr, work = run.device_trace, run.traced_work.get("decode")
    if tr is None or tr.busy_s is None or not work:
        return None
    dev_s, _ = tr.device_seconds(KERNELS)
    if dev_s <= 0:
        return None
    return 100.0 * sum(count.least_time_s(f, b) for f, b in work) / dev_s
