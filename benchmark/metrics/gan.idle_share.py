"""The device's idle share of the profiled stretch of GAN steps, %:
1 - the union of device operations' intervals over the stretch's length
(the loader's waits inside it included)."""


def read(record):
    tr = record.get("trace")
    if not tr or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
