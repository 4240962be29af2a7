"""setup_s: seconds from the process's start to the first measured
request: imports, weights made on the device, kernel builds, graph
captures, warm-up, planning (host clock)."""


def read(run):
    return run.setup_s
