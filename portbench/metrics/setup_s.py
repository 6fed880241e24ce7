"""setup_s: from the process's start to the first timed request, in seconds."""


def read(run):
    return run.setup_s
