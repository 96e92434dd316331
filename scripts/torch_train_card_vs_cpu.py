"""How far the port's training gradient on the card sits from the same
gradient on the CPU, per architecture (prints readings, asserts nothing).

    python3 scripts/torch_train_card_vs_cpu.py      # on a CUDA machine

Every architecture's smoke config, parameters drawn on the CPU (seed 0)
and copied to the card, batches of ``chip_smoke.Smoke._train_batch``
(numpy seeds): per leaf, max |card - CPU| over max |CPU| and the L2 ratio.
First paligemma, gemma3, hubert and qwen with cuBLAS's reduced-precision
bf16 reduction allowed and not (the three worst leaves each); then
paligemma, granite and gemma2 over seeds 0-2 at B=2 and B=8 (the worst
leaf each).  One JSON line per reading.
"""

import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint.store import _leaves  # noqa: E402
from repro_torch.models import train as T  # noqa: E402
from repro_torch.optim.transforms import tree_map  # noqa: E402

batch_of = chip_smoke.Smoke._train_batch


def errors(card, cpu):
    """{leaf: (max |err| / max |cpu|, ||err|| / ||cpu||)}."""
    out = {}
    for (path, a), (_, b) in zip(_leaves(card), _leaves(cpu)):
        diff = a.cpu().float() - b.float()
        scale = float(b.abs().max())
        out["/".join(map(str, path))] = (
            float(diff.abs().max()) / scale if scale else 0.0,
            float(diff.norm()) / max(float(b.float().norm()), 1e-30))
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda")
    for arch in ("paligemma-3b", "gemma3-1b", "hubert-xlarge", "qwen1.5-4b"):
        cfg = configs.smoke_config(arch)
        st = T.init_state(torch.Generator().manual_seed(0), cfg,
                          T.make_optimizer(), "cpu")
        mc, gc = T.value_and_grad(st.params, batch_of(cfg, 0, "cpu"), cfg)
        for flag in (True, False):
            torch.backends.cuda.matmul \
                .allow_bf16_reduced_precision_reduction = flag
            params = tree_map(lambda t: t.to(dev), st.params)
            md, gd = T.value_and_grad(params, batch_of(cfg, 0, dev), cfg)
            e = errors(gd, gc)
            top = sorted(e.items(), key=lambda kv: -kv[1][0])[:3]
            print(json.dumps({
                "arch": arch, "reduced_precision": flag,
                "loss": [float(md["loss"]), float(mc["loss"])],
                "top_max_rel": [(k, round(v[0], 4), round(v[1], 5))
                                for k, v in top],
                "max_l2": max(v[1] for v in e.values())}), flush=True)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    for arch in ("paligemma-3b", "granite-20b", "gemma2-9b"):
        cfg = configs.smoke_config(arch)
        st = T.init_state(torch.Generator().manual_seed(0), cfg,
                          T.make_optimizer(), "cpu")
        params = tree_map(lambda t: t.to(dev), st.params)
        for B in (2, 8):
            for seed in range(3):
                gc = T.value_and_grad(st.params,
                                      batch_of(cfg, seed, "cpu", Bs=B), cfg)[1]
                gd = T.value_and_grad(params, batch_of(cfg, seed, dev, Bs=B),
                                      cfg)[1]
                key, (worst, l2) = max(errors(gd, gc).items(),
                                       key=lambda kv: kv[1][0])
                print(json.dumps({"arch": arch, "B": B, "seed": seed,
                                  "worst": [worst, key, l2]}), flush=True)


if __name__ == "__main__":
    main()
