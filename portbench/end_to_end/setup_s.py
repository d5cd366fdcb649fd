"""setup_s: process start to the first timed submit (imports, the kernel
library loaded or built, the pool rendered, the warm-up)."""


def read(run):
    return run.setup_s
