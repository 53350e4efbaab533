"""setup_s: process start until the window opens (imports, CUDA, the
kernel and native libraries, the recording, the warm-up)."""


def read(ctx):
    return ctx.setup_s
