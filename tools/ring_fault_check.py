"""Planted-fault check of chip_smoke.py phase 26 (c)'s ring gates.

Copies the port, its kernel builds and chip_smoke.py into DEST (a
directory outside the checkout), plants a fault in the copy's ring
backward (each live step gets its own block's delta, rowsum(dO O_blk),
in place of the merged output's), makes the copy's `check` print
instead of raise, and runs the copy's two `--ring-rank` children on the
card.  Prints, per rank and case, the share each gate took: a gate that
holds the ring to the unsharded kernels must fail the fault.  The
copy's launch checks fail too (the fault recomputes each block's
forward); that is expected.  DEST is removed at the end.

    python3 tools/ring_fault_check.py DEST [--seed 0]
"""
import argparse
import json
import os
import shutil
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAULT = ("""                dq_b, dk_b, dv_b, db_b = bwd(
                    q, cur[0], cur[1], dout, lse, delta,""",
         """                fwd_ = flash_fwd if kernel else flash_fwd_reference
                o_b, _ = fwd_(q, cur[0], cur[1],
                              cur[2] if len(cur) > 2 else None,
                              _cols(bias, src, tl),
                              _seed3(seed, me * tl, src * tl),
                              kind == "diag", dropout)
                delta_b = (dout.float() * o_b.float()).sum(-1).permute(
                    0, 2, 1).reshape(b * h, tl).contiguous()
                dq_b, dk_b, dv_b, db_b = bwd(
                    q, cur[0], cur[1], dout, lse, delta_b,""")
PRINT = ("""def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)""",
         """def check(cond: bool, msg: str) -> None:
    if not cond:
        print("FAULT CHECK FAILED: " + msg[:600], flush=True)""")


def patch(path, old, new):
    with open(path) as f:
        src = f.read()
    if old not in src:
        raise SystemExit(f"{path}: the text to patch is gone")
    with open(path, "w") as f:
        f.write(src.replace(old, new))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dest")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    dest = os.path.abspath(args.dest)
    if dest == ROOT or dest.startswith(ROOT + os.sep):
        raise SystemExit("DEST must lie outside the checkout")
    shutil.rmtree(dest, ignore_errors=True)
    os.makedirs(dest)
    try:
        for name in ("analytics_zoo_tpu_torch", ".kernel_build"):
            if os.path.exists(os.path.join(ROOT, name)):
                shutil.copytree(os.path.join(ROOT, name),
                                os.path.join(dest, name))
        smoke = os.path.join(dest, "chip_smoke.py")
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), smoke)
        patch(os.path.join(dest, "analytics_zoo_tpu_torch", "parallel",
                           "ring_attention.py"), *FAULT)
        patch(smoke, *PRINT)
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        outs = [os.path.join(dest, f"ring-{r}.json") for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, smoke, "--ring-rank", str(r), str(port),
             outs[r], "--seed", str(args.seed)], cwd=dest)
            for r in range(2)]
        try:
            rcs = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        print(f"ranks exited {rcs}", flush=True)
        for path in outs:
            with open(path) as f:
                res = json.load(f)
            for name, case in res["cases"].items():
                each, whole = ({k: round(v, 4) for k, v in case[key].items()}
                               for key in ("shares", "whole_shares"))
                print(f"fault rank {res['rank']} {name}: per-element "
                      f"{each}, whole-tensor {whole}", flush=True)
    finally:
        shutil.rmtree(dest, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
