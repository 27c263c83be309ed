"""Per-bake readings of a traced run: host ms in a span, device ms of
named ops."""


def per_bake_ms(run, label):
    t = run.get("trace")
    if not t or label not in t["labels_us"] or not run["bakes"]:
        return None
    return t["labels_us"][label] / 1e3 / run["bakes"]


def device_ms(run, tags):
    """Device milliseconds per bake of the ops whose names hold a tag."""
    t = run.get("trace")
    if not t or not run["bakes"]:
        return None
    hit = [v[1] for k, v in t["kernels"].items()
           if any(tag in k for tag in tags)]
    if not hit:
        return None
    return sum(hit) / 1e3 / run["bakes"]
