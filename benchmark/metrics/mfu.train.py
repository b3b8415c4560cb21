"""The model's operations in the traced window (every tap product by the
reference's structural count, every dense product as torch counts it;
a training step's forward, dgrad and wgrad) over the window's wall time
at the card's dense bf16 peak, in %."""


def read(inp):
    p, t = inp["peaks"], inp["trace"]
    flops = inp["work"].get("model_flops")
    if p is None or not flops or t.window_s <= 0:
        return None
    return 100.0 * flops / (t.window_s * p["bf16_flops"])
