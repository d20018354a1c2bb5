"""The device's idle share of the traced window's profiled part: 100
times one less the union of its kernels, copies and sets over the part's
host-clock length."""


def read(ctx: dict):
    p = ctx["profile"]
    if not p["seconds"] or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["seconds"])
