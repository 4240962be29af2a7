"""ssd_scan_roofline: the least time of the traced batch's prefill SSD
scans (``kernel_work["ssd_scan"]``, counted from their shapes) over the
device time of the SSD kernels (``ssd_cb_kernel``, ``ssd_scan_kernel``)
in the trace.  The scan runs in fp32, so its FLOPs are taken at the rate
of fp32-accurate tensor-core products, 3xTF32 (three TF32 passes a
product: 495/3 TFLOP/s, the rate of PERF.md's kernel table), beside the
HBM bandwidth."""
from portbench import count

KERNELS = ("ssd_cb_kernel", "ssd_scan_kernel")
PEAK_3XTF32_FLOPS = 495e12 / 3


def read(run):
    tr, work = run.device_trace, run.traced_work.get("ssd_scan")
    if tr is None or tr.busy_s is None or not work:
        return None
    dev_s, _ = tr.device_seconds(KERNELS)
    if dev_s <= 0:
        return None
    least = sum(max(f / PEAK_3XTF32_FLOPS, b / count.PEAK_BYTES_S)
                for f, b in work)
    return 100.0 * least / dev_s
