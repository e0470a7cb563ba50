"""The augmentation's stream time a step: the mean over the window's steps
of the interval between the CUDA events recorded around the aug callable
handed to the step."""


def read(record):
    ms = record["aug_ms"]
    return sum(ms) / len(ms) if ms else None
