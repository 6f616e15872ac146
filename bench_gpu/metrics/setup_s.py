"""setup_s: from the process's start to the window's: importing torch and
the program, building or loading its kernels, and the warm-up job."""


def read(ctx):
    return ctx.setup_s
