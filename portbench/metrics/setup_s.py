"""Seconds from the process's start to the end of the warm-up iterations:
imports, the CUDA context, the restore, the kernel libraries and the
warm-up iterations themselves."""


def read(run):
    return run["setup_s"]
