"""Share of the traced window in which no operation ran on the card:
100 * (1 - union of device activity intervals / window), in %. Not read
when the capture lost csrc kernel launches."""


def read(rec):
    cap = rec["capture"]
    if cap is None or not rec["capture_complete"]:
        return None
    return 100.0 * (1.0 - cap["busy_s"] / rec["window_s"])
