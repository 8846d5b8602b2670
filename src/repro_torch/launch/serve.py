"""Serving entry point of the port — the counterpart of
``repro.launch.serve``:
``ServeConfig`` (the run description), ``build_engine``, the slot API
``Server``, ``make_prompts``, ``run`` and the CLI ``main``, whose flags are
the dataclass's fields. It serves synthetic requests through
``repro_torch.serve.ServeEngine`` on the card (``--device cpu`` to run on
the CPU) and prints tok/s, TTFT p50 and latency p95; it exits 1 unless
every request completed and no prefill chunk failed:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-32b \\
      --no-reduced --num-layers 4 --s-max 1024 --requests 8

The default arch is hymba-1.5b (reduced), as the reference CLI's is;
``--arch`` takes every LM arch of ``repro_torch.configs.list_archs()``:
the dense ones, the MoE ones (dbrx-132b, moonshot-v1-16b-a3b), the VLM
(llama-3.2-vision-11b, on zero image embeddings), whisper-large-v3 (its
decoder, over one encoder pass of zero frames a request group) and
``rwkv6-7b``, the attention-free family (a page size is ignored there, its
state being O(1)).

``--num-layers`` cuts the depth of the arch (its widths stay), which is
how a full-width arch fits one card. As in ``ServeConfig``, the cache is
dense unless ``--page-size`` is given; ``--kv-backend`` picks its
representation by the reference's names (``paged_int8``: int8 pages;
``paged_latent``: MLA latent pages, with an MLA arch such as
``qwen2.5-32b-mla``); ``--prefill-mode`` and
``--prefill-attn-impl`` choose the prefill path (``auto``: the
flash-attention kernel on the card); ``--quantize-int8`` serves the
weights after int8 per-channel post-training quantization (quantized, then
dequantized to the compute dtype, as the reference CLI does).
``--temperature``, ``--top-k`` and ``--top-p`` sample instead of taking
the argmax (``--seed`` seeds the weights, the prompts and the draws).

``repro``'s ``LegacyServer`` / ``run_legacy`` (the seed's token-by-token
full-batch prefill, kept there as a regression baseline) are not ported.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List, Optional

import numpy as np

from repro_torch.serve.config import ServeConfig as EngineConfig
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kvcache import BACKENDS


@dataclasses.dataclass
class ServeConfig:
    """CLI run description: the engine build knobs (mapped onto
    :class:`repro_torch.serve.config.ServeConfig` by :func:`build_engine`)
    plus the synthetic-traffic shape (``requests``/``prompt_len``/
    ``gen_len``) this module generates. The reference's fields, plus
    ``num_layers``, ``prefill_attn_impl`` and ``device``."""
    arch: str = "hymba-1.5b"
    reduced: bool = True
    num_layers: int = 0       # 0 = keep the arch's depth; >0 cuts it
    batch_slots: int = 4
    s_max: int = 64
    requests: int = 8
    prompt_len: int = 8
    gen_len: int = 16
    seed: int = 0
    quantize_int8: bool = False
    temperature: float = 0.0
    top_k: int = 0            # 0 = off; >0 restricts sampling to k best
    top_p: float = 1.0        # 1.0 = off; <1 nucleus sampling
    page_size: int = 0        # 0 = dense cache; >0 enables paged KV
    num_pages: int = 0        # 0 = dense-equivalent pool (slots x s_max/ps)
    kv_backend: str = ""      # "" = layout follows page_size; else a
    #                           kvcache.BACKENDS name (e.g. paged_latent)
    prefill_mode: str = "parallel"   # 'parallel' (chunked) | 'scan' (anchor)
    prefill_chunk: int = 64   # max prompt tokens ingested between decode ticks
    prefill_attn_impl: str = "auto"  # auto | pallas (the flash kernel) | einsum
    # True = auto (page-level prefix caching whenever the config supports it:
    # paged + parallel prefill + dense/MoE/VLM family); False = hard off
    prefix_cache: bool = True
    device: str = "cuda"


# flags whose values are a closed set
_CHOICES = {"kv_backend": [""] + sorted(BACKENDS),
            "prefill_mode": ["parallel", "scan"]}


def build_engine(sc: ServeConfig) -> ServeEngine:
    return ServeEngine.build(sc.arch, config=EngineConfig(
        reduced=sc.reduced,
        cfg_overrides=({"num_layers": sc.num_layers} if sc.num_layers
                       else None),
        batch_slots=sc.batch_slots, s_max=sc.s_max, seed=sc.seed,
        quantize_int8=sc.quantize_int8,
        temperature=sc.temperature, top_k=sc.top_k, top_p=sc.top_p,
        page_size=sc.page_size or None, num_pages=sc.num_pages or None,
        kv_backend=sc.kv_backend or None,
        prefix_cache=None if sc.prefix_cache else False,
        prefill_mode=sc.prefill_mode,
        prefill_chunk_tokens=sc.prefill_chunk,
        prefill_attn_impl=sc.prefill_attn_impl, device=sc.device))


class Server:
    """Slot API over the engine: ``add_request`` submits a prompt and admits
    it into a free slot (its prefill runs on the following ticks, never
    stepping the other slots); ``step_all`` is one engine tick."""

    def __init__(self, sc: ServeConfig):
        self.sc = sc
        self.engine = build_engine(sc)
        self.cfg = self.engine.cfg
        self.model = self.engine.model
        self.params = self.engine.params
        # last request to occupy each slot (outputs survive slot recycling
        # until the slot is reused)
        self._slot_hist: List[Optional[object]] = [None] * sc.batch_slots

    @property
    def cache(self):
        return self.engine.cache

    @property
    def slot_free(self) -> List[bool]:
        return [r is None for r in self.engine.slot_req]

    @property
    def outputs(self) -> List[List[int]]:
        return [list(r.tokens) if r is not None else []
                for r in self._slot_hist]

    def add_request(self, prompt: np.ndarray, gen_len: int) -> Optional[int]:
        """Admit a prompt into a free slot; returns the slot or None."""
        free = self.engine.free_slots
        if not free:
            return None
        req = self.engine.submit(prompt, gen_len)
        self.engine.admit()
        self._slot_hist[req.slot] = req
        return req.slot

    def step_all(self) -> int:
        """One engine tick for every active slot; returns #active."""
        return self.engine.step()


def make_prompts(sc: ServeConfig, vocab: int) -> List[np.ndarray]:
    rng = np.random.default_rng(sc.seed)
    return [rng.integers(0, vocab, sc.prompt_len) for _ in range(sc.requests)]


def run(sc: ServeConfig) -> dict:
    """Serve sc.requests synthetic prompts through the engine; returns
    ``requests``/``wall_s``/``tokens_per_s``, the device, the engine's
    ``prefill_failures`` (chunks that raised and aborted their job), and
    the full engine metrics summary under ``metrics``."""
    engine = build_engine(sc)
    for prompt in make_prompts(sc, engine.cfg.vocab_size):
        engine.submit(prompt, sc.gen_len)
    summary = engine.run()
    return {"requests": summary["requests"], "wall_s": summary["wall_s"],
            "tokens_per_s": summary["throughput_tokens_per_s"],
            "device": str(engine.device),
            "prefill_failures": engine.prefill_failures, "metrics": summary}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for f in dataclasses.fields(ServeConfig):
        name = "--" + f.name.replace("_", "-")
        if isinstance(f.default, bool):
            ap.add_argument(name, action=argparse.BooleanOptionalAction,
                            default=f.default)
        else:
            ap.add_argument(name, type=type(f.default), default=f.default,
                            choices=_CHOICES.get(f.name))
    ap.add_argument("--json", action="store_true", help="print full metrics")
    args = ap.parse_args(argv)
    sc = ServeConfig(**{f.name: getattr(args, f.name)
                        for f in dataclasses.fields(ServeConfig)})
    stats = run(sc)
    m = stats["metrics"]
    if args.json:
        print(json.dumps(dict(m, prefill_failures=stats["prefill_failures"]),
                         indent=2, default=float))
    print(f"served {stats['requests']} requests on {stats['device']}, "
          f"{stats['tokens_per_s']:.1f} tok/s | "
          f"ttft p50 {m['ttft_s']['p50'] * 1e3:.1f} ms | "
          f"latency p95 {m['latency_s']['p95'] * 1e3:.1f} ms")
    # a chunk that raised (a kernel that did not build or launch) aborted
    # its request: the run failed, whatever the timings say
    if m["completed"] != sc.requests or stats["prefill_failures"]:
        print(f"{sc.requests - m['completed']} of {sc.requests} requests "
              f"not completed, {stats['prefill_failures']} prefill chunk(s) "
              f"failed")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
