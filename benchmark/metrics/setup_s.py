"""setup_s: from the start of the process to the end of the checked,
warming steps or samples: imports, CUDA, the build, the weights, the
thermalization and the warm-up."""


def read(run):
    return run.get("setup_s")
