"""moe_experts_roofline: the least time of the traced batch's dropless
expert products (``kernel_work["moe"]``: FLOPs and bytes counted from
their shapes, at the bf16 peak and HBM bandwidth) over the device time of
the grouped-GEMM kernels in the trace (CUTLASS's grouped GEMM that
``torch._grouped_mm`` launches, named by its ``GroupProblemShape``, and
the kernel that prepares its groups).  No reading where the trace has no
such kernel."""
from portbench import count

KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def read(run):
    tr, work = run.device_trace, run.traced_work.get("moe")
    if tr is None or tr.busy_s is None or not work:
        return None
    dev_s, _ = tr.device_seconds(KERNELS)
    if dev_s <= 0:
        return None
    return 100.0 * sum(count.least_time_s(f, b) for f, b in work) / dev_s
