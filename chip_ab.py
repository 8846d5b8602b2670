#!/usr/bin/env python3
"""Two trees of the port on one NVIDIA card, timed in turns: the
full-width attention rows of ``chip_smoke.py`` phase 2 (K4, latent paged
attention, and K2, flash attention) and phase 7's serving of
qwen2.5-32b-mla (4 layers) on the dense latent cache and on latent pages.

    python3 chip_ab.py OTHER_TREE

OTHER_TREE is another checkout of the repository, unpacked with
``git archive`` (for example the parent commit's, into a directory that
``.gitignore`` lists). The script runs one worker process per turn, in
the order other, this, this, other. A worker imports the ``repro_torch``
package of its tree first, so this tree's ``chip_smoke`` then builds and
launches that tree's kernels (into that tree's own build directory), and
runs ``phase2_latent_full_width``, ``phase2_flash_full_width`` and
``phase7_mla`` as they are. Prints each worker's lines, then one JSON
object ``{"ab": [{"tree": ..., "card": ..., "kernels": {...}, "serving":
{...}}, ...]}`` with the turns in order. Needs CUDA; exits nonzero if any
worker fails.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent


def worker(tree: pathlib.Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import repro_torch  # noqa: F401  (the tree's package, before chip_smoke)
    sys.path.insert(1, str(HERE))
    import chip_smoke as cs
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_name()
    cs.log(f"worker: {pathlib.Path(repro_torch.__file__).parent} on {card}")
    rows = {f"paged_attention_latent[{kind.split('_')[0]}]": f
            for kind, f in cs.phase2_latent_full_width().items()}
    rows.update({f"flash_attention[{kind}]": f
                 for kind, f in cs.phase2_flash_full_width().items()})
    _, served = cs.phase7_mla(card)
    serving = {cache: {"ttft_p50_ms": m["ttft_s"]["p50"] * 1e3,
                       "itl_p50_ms": m["itl_s"]["p50"] * 1e3,
                       "tok_per_s": m["throughput_tokens_per_s"]}
               for cache, m in served.items()}
    return {"tree": str(tree), "card": card, "kernels": rows,
            "serving": serving}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        print("AB " + json.dumps(worker(pathlib.Path(sys.argv[2]))),
              flush=True)
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: CUDA is not available", file=sys.stderr)
        return 1
    other = pathlib.Path(sys.argv[1]).resolve()
    results = []
    for tree in (other, HERE, HERE, other):
        proc = subprocess.run([sys.executable, __file__, "--worker",
                               str(tree)], capture_output=True, text=True)
        lines = proc.stdout.splitlines()
        print("\n".join(ln for ln in lines if not ln.startswith("AB ")),
              flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        results += [json.loads(ln[3:]) for ln in lines
                    if ln.startswith("AB ")]
    print(json.dumps({"ab": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
