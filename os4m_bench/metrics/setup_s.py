"""setup_s: seconds from the process's start to the window's start (imports,
the CUDA context, the kernels' build or load, the batches drawn, warm-up)."""


def read(run):
    return run.setup_s
