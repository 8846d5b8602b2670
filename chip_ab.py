#!/usr/bin/env python3
"""Two trees of the port on one NVIDIA card, timed in turns: the
full-width attention rows of ``chip_smoke.py`` phase 2 (K1 and K3, paged
attention over fp32 and int8 pages; K4, latent paged attention; K2, flash
attention) and its scan rows (K5, the wkv6 scan; K6, the selective scan),
phases 4 and 4b's serving of qwen2.5-32b (4 layers) on fp32 and int8
pages, phase 7's serving of qwen2.5-32b-mla (4 layers) on the dense latent
cache and on latent pages, and hymba-1.5b's (32 layers, phase 10's
weights) host wall and device busy time of one decode tick and one
64-token first chunk.

    python3 chip_ab.py [--attention | --gemm] OTHER_TREE

OTHER_TREE is another checkout of the repository, unpacked with
``git archive`` (for example the parent commit's, into a directory that
``.gitignore`` lists). The script runs one worker process per turn, in
the order other, this, this, other. A worker imports the ``repro_torch``
package of its tree first, so this tree's ``chip_smoke`` then builds and
launches that tree's kernels (into that tree's own build directory), and
runs ``phase2_full_width``, ``phase2_q8_full_width``,
``phase2_latent_full_width``, ``phase2_flash_full_width``,
``phase2_scan_full_width``, ``phase4_serve``, ``phase4b_serve_int8``,
``phase7_mla`` and ``tick_and_chunk`` as they are. Prints each worker's
lines, then one JSON object ``{"ab": [{"tree": ..., "card": ...,
"kernels": {...}, "serving": {...}, "recurrent": {...}}, ...]}`` with the
turns in order. With ``--attention`` a worker runs the attention rows
(K1, K3, K4, K2) and nothing else. With ``--gemm`` it runs the GEMM rows
and nothing else: ``phase2_gemm_full_width`` (K7 in each dataflow and K8
over a batch-256 ResNet20 forward's 21 GEMMs, and at qwen2.5-32b's wo),
``phase2_backward_gemms`` (K7's 20 dX and 21 dW GEMMs of a batch-128
training step) and ``phase16_step_cost`` (that step's host wall, device
busy time and idle share through K7 and through the plain route), its
JSON with ``"training_step"`` in place of serving. Needs CUDA; exits
nonzero if any worker fails.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent


def worker(tree: pathlib.Path, mode: str = "") -> dict:
    sys.path.insert(0, str(tree / "src"))
    import repro_torch  # noqa: F401  (the tree's package, before chip_smoke)
    sys.path.insert(1, str(HERE))
    import chip_smoke as cs
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_name()
    cs.log(f"worker: {pathlib.Path(repro_torch.__file__).parent} on {card}")
    rows = {}
    if mode == "--gemm":
        rows.update({f"matmul[{key}]": f for key, f in
                     cs.phase2_gemm_full_width().items()})
        rows.update({f"matmul[{role} resnet20 B={cs.TRAIN_BATCH}]": f
                     for role, f in cs.phase2_backward_gemms(card).items()})
        return {"tree": str(tree), "card": card, "kernels": rows,
                "training_step": cs.phase16_step_cost(card)}
    for name, phase in (("paged_attention", cs.phase2_full_width),
                        ("paged_attention_q8", cs.phase2_q8_full_width),
                        ("paged_attention_latent",
                         cs.phase2_latent_full_width)):
        rows.update({f"{name}[{kind.split('_')[0]}]": f
                     for kind, f in phase().items()})
    rows.update({f"flash_attention[{kind}]": f
                 for kind, f in cs.phase2_flash_full_width().items()})
    if mode == "--attention":
        return {"tree": str(tree), "card": card, "kernels": rows}
    rows.update({f"{name}[{kind}]": f for (name, kind), f in
                 cs.phase2_scan_full_width().items()})

    # phases 4 and 4b: qwen2.5-32b (4 layers) on fp32 and int8 pages
    dense = cs.ServeEngine.build(cs.ARCH, config=cs.ServeConfig(
        reduced=False, cfg_overrides={"num_layers": cs.LAYERS},
        s_max=cs.S_MAX, batch_slots=cs.SLOTS))
    model, params = dense.model, dense.params
    prompts = cs.serve_prompts(dense.cfg.vocab_size)
    _, reqs, firsts, nbytes, m_fp32 = cs.phase4_serve(model, params,
                                                      prompts, card)
    _, m_int8, _ = cs.phase4b_serve_int8(model, params, prompts, card,
                                         (reqs, firsts, nbytes))
    served = {"fp32 pages": m_fp32, "int8 pages": m_int8}
    del dense, model, params
    torch.cuda.empty_cache()

    _, mla = cs.phase7_mla(card)
    served.update({f"mla {cache}": m for cache, m in mla.items()})

    # phase 10's hymba-1.5b: a tick of 8 idle slots, a chunk of one request
    engine = cs.build_recurrent(cs.HYMBA, cs.HYMBA_LAYERS, cs.HYMBA_S_MAX)
    prompt = cs.serve_prompts(engine.cfg.vocab_size)[0]
    recurrent = {f"hymba {kind}": m for kind, m in cs.tick_and_chunk(
        engine, prompt, card, "hymba dense ring").items()}
    del engine
    torch.cuda.empty_cache()
    serving = {cache: {"ttft_p50_ms": m["ttft_s"]["p50"] * 1e3,
                       "itl_p50_ms": m["itl_s"]["p50"] * 1e3,
                       "tok_per_s": m["throughput_tokens_per_s"]}
               for cache, m in served.items()}
    return {"tree": str(tree), "card": card, "kernels": rows,
            "serving": serving, "recurrent": recurrent}


def main() -> int:
    args = sys.argv[1:]
    modes = [a for a in args if a in ("--attention", "--gemm")]
    args = [a for a in args if a not in modes]
    if len(args) == 2 and args[0] == "--worker" and len(modes) < 2:
        print("AB " + json.dumps(worker(pathlib.Path(args[1]),
                                        "".join(modes))), flush=True)
        return 0
    if len(args) != 1 or len(modes) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: CUDA is not available", file=sys.stderr)
        return 1
    other = pathlib.Path(args[0]).resolve()
    results = []
    for tree in (other, HERE, HERE, other):
        proc = subprocess.run([sys.executable, __file__, "--worker",
                               str(tree)] + modes,
                              capture_output=True, text=True)
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
