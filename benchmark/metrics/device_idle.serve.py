"""The share of the traced part of the window in which no operation ran
on the device (the union of the device operations' intervals), averaged
over the cards, in percent."""


def read(run):
    t = run.device_trace
    if t is None or not t["cards"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
