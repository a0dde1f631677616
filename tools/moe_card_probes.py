"""Card probes of the port's mixture-of-experts paths, run on one GPU.

    python3 tools/moe_card_probes.py scatter   # captured vs eager
    python3 tools/moe_card_probes.py train     # phase 7's MoE form, per tensor

``scatter``: a tiny bf16 MoE paged engine (8 experts at capacity 1, so
decode and prefill drop tokens) serves 11 greedy requests on captured
programs and on its eager bodies, three times with a plain scatter of
the sink page and three times with the shipped last-writer scatter
(``llama._last_writer``), in turns; prints how many requests differ
captured vs eager in each run.

``train``: ``chip_smoke.py`` phase 7's small f32 models (MoE at
capacity 2 and 4, and dense) trained 2 steps on the card and on the CPU
from the same weights, each side on its own parameters; prints, per step
and tensor, the worst |card - cpu| over the tensor's max, the elements
over phase 7's rule (1e-4 * max|cpu| + 1e-3 * |cpu|) and the parameter
gap AdamW left before the step.

Both exit non-zero without a card.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ray_tpu_torch.llm import (  # noqa: E402
    PagedEngineConfig, PagedInferenceEngine, SamplingParams,
)
from ray_tpu_torch.models import llama  # noqa: E402


def scatter() -> None:
    shipped = llama._last_writer
    mc = llama.llama_tiny(vocab_size=300, dim=256, n_heads=4, n_kv_heads=2,
                          mlp_dim=512, max_seq_len=512, dtype=torch.bfloat16,
                          moe_experts=8, moe_capacity=1.0)
    cfg = PagedEngineConfig(model=mc, max_batch_size=8, page_size=16,
                            num_pages=192, max_pages_per_seq=32,
                            chunk_size=64, prefill_rows=4, decode_window=4)
    params = llama.init(mc, seed=4, device="cuda")
    rng = np.random.RandomState(6)
    prompts = [[int(t) for t in rng.randint(0, 300, n)]
               for n in (70, 5, 33, 17, 90, 12, 40, 8, 120, 3, 55)]
    try:
        for last_writer in (False, True) * 3:
            llama._last_writer = (shipped if last_writer
                                  else (lambda idx, cfg: None))
            tokens = []
            for eager in (False, True):
                eng = PagedInferenceEngine(cfg, params, rng_seed=3,
                                           device="cuda")
                eng._eager = eager
                eng.warmup(sample_modes=((False, False),))
                out = eng.generate(prompts, SamplingParams(max_tokens=24))
                torch.cuda.synchronize()
                tokens.append([o["token_ids"] for o in out])
            diff = sum(a != b for a, b in zip(*tokens))
            print(f"{'last-writer' if last_writer else 'plain'} scatter: "
                  f"{diff} of {len(prompts)} requests differ captured vs "
                  f"eager", flush=True)
    finally:
        llama._last_writer = shipped


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _named(tree[k],
                                                         f"{prefix}{k}.")]
    return [prefix[:-1]]


def train() -> None:
    import chip_smoke as cs
    for moe in (cs.MOE_SMALL, dict(cs.MOE_SMALL, moe_capacity=4.0), {}):
        mc = cs._small_model(remat=True, remat_policy="save_attn", **moe)
        tok = np.random.RandomState(11).randint(0, mc.vocab_size, (2, 161))
        runs = {}
        for device in ("cuda", "cpu"):
            params = llama.init(mc, seed=5, device="cpu")
            names = _named(params)
            params = {k: ({n: t.to(device) for n, t in v.items()}
                          if isinstance(v, dict) else v.to(device))
                      for k, v in params.items()}
            tokens = torch.as_tensor(tok, dtype=torch.int64, device=device)
            step = cs._train_step_fn(params, mc, tokens)
            leaves = cs._leaves(params)
            rec = []
            for _ in range(2):
                before = [t.detach().cpu().clone() for t in leaves]
                _, logits, _ = step()
                rec.append((before, [logits.cpu()] +
                            [t.grad.detach().cpu() for t in leaves]))
            runs[device] = rec
        print("config", moe or "dense", flush=True)
        for s in range(2):
            (pc, tc), (pp, tp) = runs["cuda"][s], runs["cpu"][s]
            for i, (a, b) in enumerate(zip(tc, tp)):
                err = (a - b).abs()
                mx = float(b.abs().max())
                over = int((err > 1e-4 * mx + 1e-3 * b.abs()).sum())
                name = "logits" if i == 0 else names[i - 1]
                gap = "" if i == 0 else (
                    f", parameter gap "
                    f"{float((pc[i - 1] - pp[i - 1]).abs().max()):.3g}")
                print(f"  step {s} {name}: max {mx:.3g}, worst "
                      f"{float(err.max()) / (mx + 1e-30):.3g} of it, "
                      f"{over} over the rule{gap}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("moe_card_probes: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    what = sys.argv[1:] or ["scatter", "train"]
    for name in what:
        {"scatter": scatter, "train": train}[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
