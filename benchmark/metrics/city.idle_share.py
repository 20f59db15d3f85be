"""The device's idle share over one whole city of the traced run (the first
of the window), %: 1 - the union of device operations' intervals over the
city's length."""


def read(record):
    tr = record.get("trace")
    if not tr or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
