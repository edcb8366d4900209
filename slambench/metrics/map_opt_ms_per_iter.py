"""The mapping iterations' optimiser (the program's `map.opt` spans:
`zero_grad`, Adam's step and the fused decoders' bf16 rounding) in host
ms an iteration over the window: `us.map.opt` over the mapping
iterations, both from `UniSLAM.iters_run`."""


def read(run):
    it = (run.get("stats") or {}).get("iters", {})
    if "us.map.opt" not in it or not it.get("map"):
        return None
    return it["us.map.opt"] / 1e3 / it["map"]
