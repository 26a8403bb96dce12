"""Times of the zoo's bandwidth kernels #30 (ew_call) and #35 + #36 (the
grid softmax), the way chip_smoke.py's [zoo] times them.

    python -m tpukern_torch.harness.zoo_times [label] [--softmax]

Prints the card's name and power limit, then one line per call, each
the median of 20 calls with the L2 flushed before every call
(chip_smoke.py ZOO_TIMING), in µs beside the bound (bytes over 3.35
TB/s, each input read once and each output written once) and one
PyTorch call of the same function on the same inputs:

- #30's six tiers of add and of gelu at 4096 x 4096, beside `torch.add`
  and `F.gelu(approximate="tanh")`; add is held to its plain version bit
  for bit, gelu by its largest difference;
- the grid softmax variants `online_f32_grid` and `online_bf16_grid` at
  4096 x 4096 (the path each takes and its launches a call), beside
  `torch.softmax`, held by `ops_bench.softmax_check`; #35 and #36 alone
  in f32 at their 64 x 512 tiles;
- a digest (sha1 of the output's bytes) of every op of `_ew.OPS` at
  every tier on 4095 x 4097 elements (a tail in every tier) and on a
  view 2 elements off, to hold two trees' outputs equal bit for bit.

--softmax times the softmax lines alone. A tree without the cluster
kernel counts no launches of it, so the script also times an earlier
version of the kernels: run it in one
command from each tree's own root (`cd <tree> && python -m
tpukern_torch.harness.zoo_times <label>`), the trees in turns. Needs a
CUDA device.
"""

import hashlib
import subprocess
import sys

import torch
import torch.nn.functional as F

from tpukern_torch.harness import ops_bench
from tpukern_torch.harness.bench import run_benchmark
from tpukern_torch.ops import _ew
from tpukern_torch.ops import softmax as sm

TIMING = dict(warmup=2, iters=20, reps=1, flush_l2=True)
N = 4096


def _us(fn):
    return 1e3 * run_benchmark(fn, **TIMING)


def _line(label, name, fn, nbytes, lib=None, note=""):
    us = _us(fn)
    lib_us = None if lib is None else _us(lib)
    bound = 1e6 * nbytes / ops_bench.PEAK_BYTES_S
    print(f"[{label}] {name:44s} {us:8.1f} us  library "
          f"{'none' if lib_us is None else f'{lib_us:8.1f} us'}  bound "
          f"{bound:6.1f} us ({bound / us:.1%})  {note}", flush=True)
    return us


def _ew_lines(label, gen):
    xs = {dt: [torch.randn(N, N, generator=gen, device="cuda").to(dt)
               for _ in range(2)] for dt in (torch.float32, torch.bfloat16)}
    for op, lib in (("add", torch.add),
                    ("gelu", lambda x: F.gelu(x, approximate="tanh"))):
        for suffix, dt, vec in _ew.EW_TIERS:
            args = xs[dt][:_ew.OPS[op][1]]
            out, ref = _ew.ew_call(op, *args, vec=vec), _ew.ew_ref(op, *args)
            err = (out.float() - ref.float()).abs().max().item()
            note = (f"bit-equal {torch.equal(out, ref)}" if op == "add"
                    else f"max_abs {err:.3e}")
            nbytes = (len(args) + 1) * args[0].numel() * args[0].element_size()
            _line(label, f"ew {op}_{suffix} ({vec} a load)",
                  lambda a=args, v=vec: _ew.ew_call(op, *a, vec=v), nbytes,
                  lambda a=args: lib(*a), note)


def _ew_digests(label, gen):
    n = 4095 * 4097
    base = torch.randn(2, n + 2, generator=gen, device="cuda")
    for dt in (torch.float32, torch.bfloat16):
        b = base.to(dt)
        for view, xs in (("aligned", [b[0, :n], b[1, :n]]),
                         ("off by 2", [b[0, 2:], b[1, 2:]])):
            for op, (_, nargs, _) in _ew.OPS.items():
                args, scalars = xs[:nargs], ()
                if op in ("exp_sub", "div"):
                    args, scalars = xs[:1], (torch.tensor(
                        1.75, device="cuda"),)
                for suffix, tdt, vec in _ew.EW_TIERS:
                    if tdt != dt:
                        continue
                    out = _ew.ew_call(op, *args, scalars=scalars, vec=vec)
                    h = hashlib.sha1(out.view(torch.uint8).cpu().numpy()
                                     .tobytes()).hexdigest()[:16]
                    print(f"[{label}] digest ew {op}_{suffix} {view} {h}")


def _launches():
    fns = [sm.grid_stats, sm.grid_norm]
    if hasattr(sm, "grid_fused"):
        fns.append(sm.grid_fused)
    return {f.__name__: f.launches for f in fns}


def _softmax_line(label, name, x, fn):
    before = _launches()
    out = fn(x)
    again = fn(x)
    torch.cuda.synchronize()
    made = {k: (v - before[k]) // 2 for k, v in _launches().items()
            if v != before[k]}
    ok, err, _ = ops_bench.softmax_check(out, sm.softmax_ref(x), x.dtype)
    note = (f"launches a call {made}; check {'ok' if ok else 'MISS'} "
            f"max_abs {err:.3e}; repeats {torch.equal(out, again)}")
    return _line(label, name, lambda: fn(x), 2 * x.numel() * x.element_size(),
                 lambda: torch.softmax(x, -1), note)


def _softmax_lines(label, gen):
    xs = {dt: (3 * torch.randn(N, N, generator=gen, device="cuda")).to(dt)
          for dt in (torch.float32, torch.bfloat16)}
    for dt, x in xs.items():
        tag = "f32" if dt == torch.float32 else "bf16"
        _softmax_line(label, f"softmax online_{tag}_grid {N}x{N}", x,
                      sm.online_softmax_grid)
    x = xs[torch.float32]
    m, d = sm.grid_stats(x)
    part = m.numel() * 8
    _line(label, "softmax #35 grid_stats alone f32", lambda: sm.grid_stats(x),
          x.numel() * 4 + part)
    _line(label, "softmax #36 grid_norm alone f32",
          lambda: sm.grid_norm(x, m, d), 2 * x.numel() * 4 + part)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    label = next((a for a in argv if not a.startswith("--")), "zoo")
    if not torch.cuda.is_available():
        raise RuntimeError("zoo_times times CUDA kernels: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "--softmax" not in argv:
        _ew_lines(label, gen)
        _ew_digests(label, gen)
    _softmax_lines(label, gen)


if __name__ == "__main__":
    main()
