"""flash_attention_roofline: the least time of the traced batch's prefill
attention calls (FLOPs and bytes counted from their shapes, at the bf16
peak and HBM bandwidth) over the device time of the flash kernel in the
trace."""
from portbench import count

KERNELS = ("flash_attention_bf16_kernel", "flash_attention_fp32_kernel")


def read(run):
    tr, work = run.device_trace, run.traced_work.get("flash")
    if tr is None or tr.busy_s is None or not work:
        return None
    dev_s, _ = tr.device_seconds(KERNELS)
    if dev_s <= 0:
        return None
    return 100.0 * sum(count.least_time_s(f, b) for f, b in work) / dev_s
