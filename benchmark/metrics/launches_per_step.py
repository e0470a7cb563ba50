"""Device operations (kernels, copies, sets) a step, counted in the traced
steps."""


def read(record):
    if not record["device"]:
        return None
    return len(record["device"]) / record["steps"]
