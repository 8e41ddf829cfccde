"""Batched-request serving example on the PyTorch port: prefill a batch of
prompts against a small model, then decode greedily with one shared serve
step — the paper-kind end-to-end inference run.

Run:  PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]
      [--smoke]

The model is the reference example's (``examples/serve_batched.py``): six
dense layers, a sliding window of 512, tied embeddings.  ``--device``
defaults to ``cuda`` and fails at once where there is none; ``--smoke``
serves a small batch (2 prompts of 16, 4 tokens) for a quick check.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import ModelConfig, init_params  # noqa: E402
from repro_torch.models.config import uniform_dense_groups  # noqa: E402

CFG = ModelConfig(
    name="serve-demo", family="dense", d_model=256, num_heads=8,
    num_kv_heads=4, d_ff=1024, vocab_size=8192,
    groups=uniform_dense_groups(6), window=512, remat=False,
    tie_embeddings=True)

BATCH, PROMPT, GEN = 16, 96, 48
SMOKE = (2, 16, 4)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help=f"batch, prompt and gen of {SMOKE}")
    args = ap.parse_args()
    batch, prompt, gen = SMOKE if args.smoke else (BATCH, PROMPT, GEN)
    device = resolve_device(args.device)

    print(f"model ~{CFG.param_count()/1e6:.1f}M params, SWA window "
          f"{CFG.window}; batch={batch} prompt={prompt} gen={gen} "
          f"on {device}")
    params = init_params(0, CFG, device=device)
    reqs = pipeline.make_batch(CFG, pipeline.DataConfig(batch, prompt, seed=5),
                               0, device=device)
    reqs.pop("labels")

    res = serve.generate(params, CFG, reqs, gen=gen)
    print(f"prefill {batch}x{prompt} tokens: {res.prefill_s*1e3:.0f} ms")
    print(f"decode: {gen} steps in {res.decode_s*1e3:.0f} ms "
          f"-> {batch*gen/res.decode_s:,.0f} tok/s aggregate, "
          f"{res.decode_s/gen*1e3:.1f} ms/step")
    for b in range(min(3, batch)):
        print(f"  request {b}: ...{res.tokens[b, :12].tolist()}")


if __name__ == "__main__":
    main()
