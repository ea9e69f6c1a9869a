"""The share of the traced aggregation window in which no device
operation ran: one minus the union of the device's operation intervals
over the window's length."""


def read(record):
    trace = record["trace"]
    if trace is None or trace["busy_s"] <= 0:
        return None
    return 100 * (1 - trace["busy_s"] / trace["window_s"])
