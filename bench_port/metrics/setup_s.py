"""setup_s: seconds from the process's start to the first timed solve
(host clock): imports, the CUDA context, loading the built kernels (and in
a checkout's first run building them), making the inputs, the warm-up solve."""


def read(ctx):
    return ctx.setup_s
