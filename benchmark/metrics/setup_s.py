"""setup_s: seconds from the process's start to the window's first request
(imports, kernel build or cache load, generation, upload, warm-up)."""


def read(run):
    return run.setup_s
