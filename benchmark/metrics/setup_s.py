"""Set-up: from the start of the process to the start of the window
(import, kernel load or build, weights, the program's own preparation,
inputs, warm-up), host clock."""


def read(run):
    return run.setup_s
