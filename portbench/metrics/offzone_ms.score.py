"""Device-busy ms a batch that no kernel-zone kernel covers: the traced
stretch's busy seconds less the device seconds of every kernel family
(kernels/*.json), per call. That is cuDNN's convolutions, torch's glue
and the copies: where the work outside the zone lands, as the atrous
branches, their recompressions and a widened deep decoder do."""


def read(ctx):
    t = ctx["trace"]
    if not t or not t["calls"]:
        return None
    zone_s = sum(f["device_s"] for f in t["families"].values())
    return 1e3 * (t["busy_s"] - zone_s) / t["calls"]
