"""Serve-phase step times of two or more checkouts on one card, in turn.

    python3 serve_ab.py OLD NEW NEW OLD      # checkout roots, run in order
    python3 serve_ab.py OLD eager:NEW OLD    # NEW's steps only eagerly

Each argument is the root of a checkout that holds ``chip_smoke.py``.  For
each one, in the order given, a fresh process in that root imports its
``chip_smoke``, builds its kernels and runs its serve phase for every
scheme (llama3.2-1b at full width, random weights from the seed), so that
two versions of the engine are compared within one machine and one call;
alternating them (A B B A) shows how far the host clock drifts between
runs of the same code.  ``eager:ROOT`` serves the same requests with a
checkout whose engine captures CUDA graphs, every step (warm-up
included) issued eagerly, so that that process captures no graph, as a
checkout from before the graphs did not.  Every serve row is printed as
the checkout's script prints it, then one summary line per run
``{"run": i, "tree": ..., "scheme": ..., "decode_step_ms_p50": ...,
"eager_decode_step_ms_p50": ...}`` (in a run whose steps are all eager,
whether a checkout from before the graphs or an ``eager:`` run, that
step's p50 is under one key and the other is null) and last the card's
name and power limit.  Exits non-zero if a run fails or there is no
card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

CHILD = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
cs.phase_build()
from repro_torch import configs
from repro_torch.models import transformer
cfg = configs.get("llama3.2-1b")
params = transformer.init_params(cfg, cs.SEED, dev)
for scheme in cs.SCHEMES:
    cs.phase_serve(dev, cfg, params, scheme)
    torch.cuda.empty_cache()
"""

EAGER_CHILD = CHILD.split("for scheme")[0] + """
import json, statistics
for scheme in cs.SCHEMES:
    engine = cs.make_engine(cfg, params, scheme, dev)
    engine.eager = True
    cs.serve(engine, prompts=cs._prompts(cfg, 1, 16, cs.SEED + 7),
             new_tokens=2)
    run = cs._timed_serve(engine, scheme, cs._prompts(
        cfg, cs.N_REQUESTS, cs.PROMPT, cs.SEED), eager=True)
    assert engine.decode_compilations == 0
    print(json.dumps({"phase": "serve", "scheme": scheme, "eager_only": True,
                      "decode_step_ms_p50": None,
                      "eager_decode_step_ms_p50":
                      statistics.median(run["decode_ms"])}), flush=True)
    del engine
    torch.cuda.empty_cache()
"""


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available() or not argv:
        print(__doc__, file=sys.stderr)
        return 2
    summary = []
    for i, tree in enumerate(argv):
        eager = tree.startswith("eager:")
        root = Path(tree.removeprefix("eager:")).resolve()
        proc = subprocess.run([sys.executable, "-c",
                               EAGER_CHILD if eager else CHILD], cwd=root,
                              capture_output=True, text=True, timeout=900)
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            print(f"serve_ab: run {i} in {tree} exited {proc.returncode}",
                  file=sys.stderr)
            return 1
        for line in proc.stdout.splitlines():
            row = json.loads(line) if line.startswith("{") else {}
            if row.get("phase") == "serve":
                summary.append({
                    "run": i, "tree": tree, "scheme": row["scheme"],
                    "decode_step_ms_p50": row["decode_step_ms_p50"],
                    "eager_decode_step_ms_p50":
                    row.get("eager_decode_step_ms_p50")})
    for s in summary:
        print(json.dumps(s), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
