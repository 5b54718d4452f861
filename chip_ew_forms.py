"""Which special-function forms B1-B3 keep, measured on one CUDA card.

Run from the repository root:  python3 chip_ew_forms.py

Builds ``enflows_tpu_torch/ops/csrc/elementwise.cu`` once per variant
(``VARIANTS``: the ``EW_FAST`` mask of approximate forms, bit 0 exp, 1 log,
2 reciprocals and divisions, 3 sqrt), one ``nvcc`` per variant, all started
together. For each variant it runs the B1, B2 and
B3 phases of ``chip_smoke.py`` under their unchanged gates (the flagship at
d=2 and d=50, the sweep in float32 and float64, the float32 corners) and
prints ptxas's registers and spills; then it times B1 (d=2, n=2^24), B2 and
B3 (d=2, n=2^22) and B1 and B3 at d=50, n=2^17 by CUDA events, the
variants in turns (forward order, then reverse; the smaller of the two),
and prints one line per variant beside the card's name and power limit.
A variant that fails a gate or spills is reported, not timed. Imports
nothing of JAX.
"""
import ctypes
import os
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))

VARIANTS = [  # (name, EW_FAST mask)
    ("accurate", 0),
    ("exp", 1),
    ("exp+log", 3),
    ("exp+log+rcp", 7),
    ("all", 15),
]


def build_variants(out_dir):
    """{name: (library path, ptxas report)}; all nvcc processes at once."""
    from enflows_tpu_torch.ops import _build

    src = _build.CSRC / "elementwise.cu"
    procs = {}
    for name, fast in VARIANTS:
        so = os.path.join(out_dir, f"ew_{fast}.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.COMPILE_FLAGS, f"-DEW_FAST={fast}",
             "-shared", "-o", so, str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{stderr}{stdout}")
        out[name] = (so, stderr + stdout)
    return out


def short(mangled):
    """'B1 E=2' or 'B3 E=2' from an instantiation's mangled name."""
    args = mangled.split("ILi")[1].split("EEv")[0].split("ELi")
    kind = "B1" if "ew_fwd" in mangled else ("B2", "B3")[int(args[1]) - 1]
    return f"{kind} E={args[0]}"


def load(so):
    from enflows_tpu_torch.ops import _build

    lib = ctypes.CDLL(so)
    for name in ("enf_fused_chain", "enf_chain_occupancy"):
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    lib.enf_error_string.argtypes = [ctypes.c_int]
    lib.enf_error_string.restype = ctypes.c_char_p
    return lib


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_ew_forms: no CUDA card")
    sys.path.insert(0, HERE)
    import chip_smoke as S
    import enflows_tpu_torch as et
    from enflows_tpu_torch.ops import _build
    from enflows_tpu_torch.ops import elementwise as EW

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = S.nvidia_smi_line()
    print(f"[gpu] {card}; torch {torch.__version__}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp)
        loaded, passed = {}, []
        for name, _ in VARIANTS:
            so, report = libs[name]
            loaded[name] = load(so)
            _build.load_library = lambda lib=loaded[name]: lib
            EW._occupancy.cache_clear()
            ents = [e for needle in ("ew_fwd_kernel", "ew_grad_kernel")
                    for e in S.ptxas_entries(report, needle)]
            regs = ", ".join(f"{short(n)} {r} registers {st}/{ld} spill"
                             for n, r, st, ld in ents)
            spills = any(st or ld for _, _, st, ld in ents)
            gen = torch.Generator(device=device).manual_seed(0)
            try:
                S.phase_b1(et, EW, 2, 1 << 24, gen, device, card)
                S.phase_b2(et, EW, 2, 1 << 22, gen, device, card)
                S.phase_b3(et, EW, 2, 1 << 22, gen, device, card)
                S.phase_sweep(et, EW, gen, device)
                S.phase_corners(et, EW, device)
                S.phase_b1(et, EW, 50, 1 << 17, gen, device, card)
                S.phase_b3(et, EW, 50, 1 << 17, gen, device, card)
                ok = not spills
                why = "spills" if spills else "gates held"
            except RuntimeError as exc:
                ok, why = False, f"failed: {str(exc)[:300]}"
            print(f"[variant] {name}: {why}; ptxas {regs}", flush=True)
            if ok:
                passed.append(name)

        # The kernels alone, variants in turns.
        gen = torch.Generator(device=device).manual_seed(1)
        shapes = []
        for mode, dim, n in (("fwd", 2, 1 << 24), ("bwd", 2, 1 << 22),
                             ("negll", 2, 1 << 22), ("fwd", 50, 1 << 17),
                             ("negll", 50, 1 << 17)):
            chain = S.flagship_flow(et, dim, gen, device)
            x = torch.randn(n, dim, generator=gen, device=device)
            plan, bufs = EW._chain_plan(chain, dim, device)
            bufs = tuple(b.detach() for b in bufs)
            extra = (torch.cos(x), torch.ones(n, device=device)) \
                if mode == "bwd" else ()
            kind = {"fwd": "B1", "bwd": "B2", "negll": "B3"}[mode]
            shapes.append((f"{kind} d={dim} n=2^{n.bit_length() - 1}",
                           mode, plan, x, bufs, extra))
        times = {name: {} for name in passed}
        for order in (passed, passed[::-1]):
            for name in order:
                _build.load_library = lambda lib=loaded[name]: lib
                EW._occupancy.cache_clear()
                for label, mode, plan, x, bufs, extra in shapes:
                    ms = S.cuda_ms(lambda: EW._launch(mode, plan, x, bufs,
                                                      *extra), iters=20)
                    prev = times[name].get(label)
                    times[name][label] = ms if prev is None else min(prev, ms)
        for name in passed:
            print(f"[forms] {name}: " + ", ".join(
                f"{label} {ms:.4f} ms" for label, ms in times[name].items())
                + f" [{card}]", flush=True)


if __name__ == "__main__":
    main()
