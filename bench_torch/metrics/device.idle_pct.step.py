"""device.idle_pct.step (%): the share of the traced window in which no
kernel or copy ran on the card, in the device-resident step cells."""


def read(w):
    if not w.device:
        return None
    return 100.0 * (1.0 - w.busy_s() / w.window_s)
