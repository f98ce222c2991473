#!/usr/bin/env python3
"""Where XLA writes the JAX generator's bf16 activations: the fusions of the
posterior encoder (its WaveNet stack) and of the HiFi-GAN decoder, read from
the compiled HLO on the CPU.

    JAX_PLATFORMS=cpu python3 tools/bf16_fusion_map.py [--out DIR]

Lowers ``vits_tpu.models.posterior_encoder.PosteriorEncoder`` (16 WaveNet
layers, kernel 5, conditioning, as the synthesizer builds it) and
``HiFiGANGenerator.hier_forward`` (the config's resblock "1", kernels
3/7/11, dilations 1/3/5, upsample rates 8/8/2/2) under bf16 at narrow
widths with ``jax.jit(...).lower(...).compile().as_text()``, and prints,
in program order, each convolution and each fusion with its output dtype
and the source ops (flax scope, op) it holds. A source op listed in two
fusions is recomputed in each (XLA duplicates cheap producers instead of
writing them). ``--out`` keeps the HLO texts. ``tools/bf16_bisect.py``'s
``fused`` mode rounds where these fusions write.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SKIP = {"parameter", "convert", "broadcast", "bitcast", "constant", "reshape", "copy",
        "transpose", "slice", "concatenate", "pad"}


def _compile(module, *args, method=None):
    import jax

    kw = {"method": method} if method else {}
    params = module.init(jax.random.PRNGKey(0), *args, **kw)
    return jax.jit(lambda p, *a: module.apply(p, *a, **kw)).lower(params, *args).compile().as_text()


def _scope(op_name: str) -> str:
    """'jit(<lambda>)/PosteriorEncoder/enc/in_3/add' -> 'enc/in_3/add'."""
    parts = [p for p in op_name.split("/") if not p.startswith("jit(")]
    return "/".join(parts[1:]) if len(parts) > 1 else "/".join(parts)


def fusions(hlo: str, batch: int) -> list[tuple[str, str, list[str]]]:
    """(kind, output type, sorted source ops) of each convolution (a 1x1 one
    is a dot) and each activation fusion (its output [batch, T, C], unlike
    the weight-norm fusions' [C] and [K, C_in, C_out]) of the entry
    computation, in program order."""
    comps = {m.group(1): m.group(2) for m in
             re.finditer(r"^%(\S+) \(.*?\) -> \S+ \{\n(.*?)^\}", hlo, re.S | re.M)}
    entry = re.search(r"^ENTRY .*?\{\n(.*?)^\}", hlo, re.S | re.M).group(1)
    rows = []
    for line in entry.splitlines():
        m = re.match(r"\s*(?:ROOT )?%\S+ = (\w+)\[([\d,]*)\]\S* (\w[\w-]*)\(", line)
        if not m:
            continue
        dtype, dims, op = m.group(1), m.group(2).split(","), m.group(3)
        if op in ("convolution", "dot"):
            srcs = re.findall(r'op_name="([^"]*)"', line)
        elif op == "fusion" and len(dims) == 3 and int(dims[0]) == batch:
            body = comps.get(re.search(r"calls=%([\w.\-]+)", line).group(1), "")
            if all(o in SKIP for o in re.findall(r"= \S+ (\w[\w-]*)\(", body)):
                continue
            srcs = re.findall(r'op_name="([^"]*)"', body)
        else:
            continue
        rows.append(("fusion" if op == "fusion" else "conv", dtype,
                     sorted({_scope(x) for x in srcs})))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="directory for the HLO texts")
    args = ap.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from vits_tpu.models.hifigan import HiFiGANGenerator
    from vits_tpu.models.posterior_encoder import PosteriorEncoder

    b, t, gin = 2, 16, 4
    pe = PosteriorEncoder(6, 4, 8, 5, 1, 16, gin_channels=gin, bf16=True)
    dec = HiFiGANGenerator(6, "1", (3, 7, 11), ((1, 3, 5),) * 3, (8, 8, 2, 2), 32,
                           (16, 16, 4, 4), gin_channels=gin, bf16=True)
    g = jnp.ones((b, 1, gin), jnp.float32)
    texts = {
        "posterior_encoder": _compile(pe, jnp.ones((b, t, 6)), jnp.asarray([t, t - 3]), g),
        "hifigan_hier": _compile(dec, jnp.ones((b, 4, 6)), g, method=dec.hier_forward),
    }
    for name, hlo in texts.items():
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"{name}.hlo.txt"), "w") as f:
                f.write(hlo)
        print(f"== {name}")
        for kind, dtype, srcs in fusions(hlo, b):
            print(f"{kind:6s} -> {dtype:4s} {' '.join(srcs)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
