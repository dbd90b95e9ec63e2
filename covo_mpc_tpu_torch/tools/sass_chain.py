"""The critical path of a kernel's step loop, from its SASS: ``chain_ms``.

A dependent chain (the sensitivity chain K3, the primal K2) cannot come
near its roofline bound, so beside it stands the least time its H
dependent steps take on one SM. It is computed from the machine code:

1. ``function_sass`` dumps one kernel's SASS from a built library with
   ``cuobjdump -sass``.
2. ``parse`` reads its instructions: address, guard predicate, opcode, the
   registers and predicates it writes and those it reads.
3. ``step_loop`` finds the innermost loops (a backward branch and the
   instructions from its target to it) and walks each body once along the
   fast path: a forward branch whose target lies inside the body is taken
   when it has no guard or when the code it skips calls a subroutine (the
   IEEE division and square root branch around their slow-path calls),
   else it falls through; one that leaves the body is not taken (the loop
   goes on), and ``BRA.DIV`` never is.
4. ``critical_path`` weights each instruction by the latency of its class
   and takes the longest path through the body's register and predicate
   dependences; the loop with the longest path is the step loop. Beside it
   stands the sum of the body's stall counts, read from each instruction's
   control bits: what one warp needs to issue a step, whatever the
   dependences.

5. ``count`` is the number of instructions along that walk: on a card whose
   schedulers each hold several warps, a step costs about its instructions
   in issue slots (``issue_ms``, one instruction a cycle a scheduler).
   ``census`` splits the walk by the source line each instruction came
   from (``nvdisasm -g`` output, which ``parse`` reads into ``Instr.line``).

``chain_ms = steps * cycles / SM clock``. The latencies are measured on the
card by ``latency_probe.cu`` (dependent chains of FFMA, IMAD, MUFU.RSQ,
MUFU.RCP, LDS, SHFL and L2-hit loads between reads of the cycle counter),
see ``measure_latencies``; ``LATENCY`` holds the values used where none is
measured. The count ignores issue slots, bank conflicts and the waits on
copies, so it is a floor: a step can take longer, never shorter.
"""

from __future__ import annotations

import ctypes
import functools
import re
import subprocess
from dataclasses import dataclass, field
from pathlib import Path

# cycles of a dependent issue by class, used where ``measure_latencies``
# gives none (the probe's classes: fp32, int, mufu, lds, shfl, ldg)
LATENCY = {"fp32": 4.0, "int": 4.0, "mufu": 18.0, "lds": 30.0, "shfl": 24.0,
           "ldg": 260.0}
_CLASS = {
    **dict.fromkeys(("FFMA", "FMUL", "FADD", "FMNMX", "FSEL", "FSET", "FSETP", "FCHK",
                     "FSWZADD", "FRND", "HFMA2", "HADD2", "HMUL2"), "fp32"),
    **dict.fromkeys(("IMAD", "IADD3", "LOP3", "SHF", "LEA", "SEL", "ISETP", "MOV",
                     "PRMT", "IABS", "IMNMX", "VIADD", "IADD", "PLOP3", "P2R", "R2P",
                     "BMSK", "SGXT", "FLO", "POPC", "BREV", "CS2R", "IDP", "I2F",
                     "F2I", "F2F", "I2FP", "F2IP"), "int"),
    "MUFU": "mufu",
    **dict.fromkeys(("LDS", "LDSM", "LDC", "S2R", "S2UR", "ULDC"), "lds"),
    **dict.fromkeys(("SHFL", "VOTE", "MATCH", "REDUX"), "shfl"),
    **dict.fromkeys(("LDG", "LD", "LDL"), "ldg"),
}
# write no register (the first operands are read or are addresses)
_NO_DEST = {"ST", "STS", "STG", "STL", "RED", "BRA", "BRX", "JMP", "JMX", "CALL", "RET",
            "EXIT", "BAR", "WARPSYNC", "BSSY", "BSYNC", "NOP", "DEPBAR", "LDGDEPBAR",
            "MEMBAR", "YIELD", "ERRBAR", "CCTL", "LDGSTS", "FENCE", "BPT", "KILL",
            "SYNCS", "UTMALDG", "UTMASTG", "ARRIVES"}
# write predicates only
_PRED_ONLY = {"ISETP", "FSETP", "DSETP", "HSETP2", "PLOP3", "FCHK", "PSETP", "UISETP",
              "UPLOP3", "R2P"}
_LINE = re.compile(r"^\s*/\*([0-9a-f]+)\*/\s+(.*?)\s*;")
_WORD = re.compile(r"/\* (0x[0-9a-f]{16}) \*/\s*$")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_SOURCE = re.compile(r'^\s*//## File "(?:[^"]*/)?([^"/]+)", line (\d+)')
_REG = re.compile(r"\b(U?R\d+|U?P\d+)(\.64|\.128)?\b")
_PRED = re.compile(r"^U?P(\d+|T)$")


@dataclass
class Instr:
    addr: int
    opcode: str  # with its modifiers, e.g. "FFMA" or "LDS.128"
    text: str
    dests: list = field(default_factory=list)
    srcs: list = field(default_factory=list)
    target: object = None  # a branch's label or address
    stall: int = 0  # cycles before the warp's next issue (the control bits)
    guarded: bool = False  # under a predicate (@P0 ...)
    line: object = None  # (file name, line) of its source, where the SASS has line info

    @property
    def base(self) -> str:
        return self.opcode.split(".")[0]


def _regs(token: str) -> list:
    """Registers and predicates named by one operand (a .64 pair: both)."""
    out = []
    for name, width in _REG.findall(token):
        n = {"": 1, ".64": 2, ".128": 4}[width]
        kind, idx = re.match(r"(U?[RP])(\d+)", name).groups()
        out += [f"{kind}{int(idx) + i}" for i in range(n)]
    return out


def _dest_width(opcode: str) -> int:
    mods = opcode.split(".")[1:]
    if "128" in mods:
        return 4
    if "64" in mods or "WIDE" in mods or opcode.split(".")[0].startswith("D"):
        return 2
    return 1


def parse(sass: str) -> list:
    """The instructions of one function's SASS, labels resolved to addresses."""
    instrs, labels, pending, source = [], {}, [], None
    lines = sass.splitlines()
    for n, line in enumerate(lines):
        src = _SOURCE.match(line)
        if src:  # the first (innermost) of a group of line-info comments
            if not (n and _SOURCE.match(lines[n - 1])):
                source = (src.group(1), int(src.group(2)))
            continue
        lab = _LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _LINE.match(line)
        if not m:
            continue
        addr, text = int(m.group(1), 16), m.group(2).strip()
        for name in pending:
            labels[name] = addr
        pending = []
        guard = None
        if text.startswith("@"):
            guard, text = text.split(None, 1)
        parts = text.split(None, 1)
        opcode, rest = parts[0], (parts[1] if len(parts) > 1 else "")
        ins = Instr(addr, opcode, text, guarded=guard is not None, line=source)
        # the second 64-bit word, on the next line, holds the control bits:
        # the stall count is its bits 41-44 (bits 105-108 of the 128)
        word = _WORD.search(lines[n + 1]) if n + 1 < len(lines) else None
        if word and _WORD.search(line):
            ins.stall = (int(word.group(1), 16) >> 41) & 0xF
        target = re.search(r"`\(([^)]*)\)|\b0x([0-9a-f]+)\b\s*$", rest)
        if ins.base in ("BRA", "CALL", "JMP") and target:
            ins.target = target.group(1) or int(target.group(2), 16)
        ops = [o.strip() for o in rest.split(",")] if rest else []
        i = 0
        if ins.base not in _NO_DEST:
            while i < len(ops) and _PRED.match(ops[i]):  # leading predicates: written
                ins.dests += [] if ops[i].endswith("PT") else [ops[i]]
                i += 1
            if ins.base not in _PRED_ONLY and i < len(ops) and re.match(r"^U?R(\d+|Z)", ops[i]):
                reg = re.match(r"^(U?R)(\d+|Z)", ops[i]).groups()
                if reg[1] != "Z":
                    ins.dests += [f"{reg[0]}{int(reg[1]) + k}"
                                  for k in range(_dest_width(opcode))]
                i += 1
        for tok in ops[i:]:
            ins.srcs += _regs(tok)
        if guard:
            ins.srcs += _regs(guard)
        instrs.append(ins)
    for ins in instrs:
        if isinstance(ins.target, str):
            ins.target = labels.get(ins.target)
    return instrs


def latency(ins: Instr, lat: dict) -> float:
    """Cycles from ``ins``'s issue to its result, by its class (0 for an
    instruction whose result nothing waits on: stores, branches, barriers)."""
    if ins.base in _NO_DEST:
        return 0.0
    base = ins.base
    if base not in _CLASS and base.startswith("U") and base[1:] in _CLASS:
        base = base[1:]  # a uniform-datapath twin
    cls = _CLASS.get(base, "fp32")
    op = f"mufu.{ins.opcode.split('.')[-1].lower()}"
    if cls == "mufu" and op in lat:
        return lat[op]
    return lat.get(cls, LATENCY[cls])


def _back_edges(instrs: list, is_back=None) -> list:
    """(target, branch) index pairs of the backward branches (those
    ``is_back(Instr)`` picks, where given)."""
    index = {ins.addr: k for k, ins in enumerate(instrs)}
    return [(index[ins.target], k) for k, ins in enumerate(instrs)
            if ins.base == "BRA" and isinstance(ins.target, int) and ins.target <= ins.addr
            and ins.target in index and (is_back is None or is_back(ins))]


def loops(instrs: list) -> list:
    """(first, last) indices of the innermost loops: a backward branch
    and its target, with no other backward branch between them."""
    back = _back_edges(instrs)
    return [(a, b) for a, b in back
            if not any(a <= a2 and b2 <= b and (a2, b2) != (a, b) for a2, b2 in back)]


def outer_loops(instrs: list, is_back=None) -> list:
    """(first, last) indices of the outermost loops: a backward branch and
    its target, inside no other such range; ``is_back(Instr)`` picks the
    backward branches that count (all by default). A loop of steps that
    waits on a barrier in a spin loop is one of these; its walk
    (``fast_path``) runs the inner loop once. The compiler may put such a
    spin loop after the kernel's code and branch back into the step loop
    from there: pick the step loops' own branches by their source line."""
    back = _back_edges(instrs, is_back)
    return [(a, b) for a, b in back
            if not any(a2 <= a and b <= b2 and (a2, b2) != (a, b) for a2, b2 in back)]


def fast_path(instrs: list, first: int, last: int) -> list:
    """The body's instructions along the fast path (module docstring)."""
    index = {ins.addr: k for k, ins in enumerate(instrs)}
    path, k = [], first
    while k < last:
        ins = instrs[k]
        path.append(ins)
        tgt = ins.target
        inside = (ins.opcode in ("BRA", "BRA.U") and isinstance(tgt, int)
                  and ins.addr < tgt <= instrs[last].addr)
        # a forward branch inside the body is taken when it jumps (no guard)
        # or when the code it skips calls a slow path
        if inside and (not ins.guarded
                       or any(i.base == "CALL" for i in instrs[k + 1:index[tgt]])):
            k = index[tgt]
        else:
            k += 1
    return path


def critical_path(path: list, lat: dict) -> tuple:
    """(cycles, the instructions on the longest dependence path) of one
    walk of a loop body, every value read from outside it ready at 0."""
    ready, via, best, end = {}, {}, 0.0, None
    for ins in path:
        start, prev = 0.0, None
        for s in ins.srcs:
            if s in ready and ready[s][0] > start:
                start, prev = ready[s]
        done = start + latency(ins, lat)
        via[id(ins)] = (ins, prev)
        for d in ins.dests:
            ready[d] = (done, ins)
        if done > best:
            best, end = done, ins
    chain = []
    while end is not None:
        chain.append(end)
        end = via[id(end)][1]
    return best, chain[::-1]


def recurrence(path: list, lat: dict) -> float:
    """The cycles of the loop's longest recurrence in one walk: over every
    loop-carried register (read in the walk before it is written there, and
    written later in it), the longest dependence path from its read to its
    last write. Unlike ``critical_path`` it leaves out what a walk starts
    for a later one and does not wait for (a load issued a step ahead)."""
    first_read, last_write = {}, {}
    for k, ins in enumerate(path):
        for r in ins.srcs:
            if r not in last_write:
                first_read.setdefault(r, k)
        for d in ins.dests:
            last_write[d] = k
    best = 0.0
    for reg in (r for r in first_read if r in last_write):
        ready = {reg: 0.0}  # the values that depend on reg's carried value
        for k, ins in enumerate(path):
            starts = [ready[r] for r in ins.srcs if r in ready]
            for d in ins.dests:
                if starts:
                    ready[d] = max(starts) + latency(ins, lat)
                else:
                    ready.pop(d, None)
            if k == last_write[reg] and reg in ready:
                best = max(best, ready[reg])
    return best


def walk(instrs: list, first: int, last: int, lat: dict) -> dict:
    """One loop's walk (``fast_path``): its critical path in cycles, the
    instructions on that path, its longest recurrence (``recurrence``, in
    cycles), the walk's length before the branch back
    (``body``) and with it (``count``, the instructions a walk issues), the
    sum of their stall counts (``issue``: the cycles one warp takes to issue
    a walk, waits on loads and barriers not counted), the walk with its
    branch back (``path``) and its address range."""
    path = fast_path(instrs, first, last)
    cycles, chain = critical_path(path, lat)
    return dict(cycles=cycles, chain=chain, recurrence=recurrence(path, lat),
                body=len(path), count=len(path) + 1,
                issue=sum(ins.stall for ins in path) + instrs[last].stall,
                path=path + [instrs[last]], range=(instrs[first].addr, instrs[last].addr))


def step_loop(sass: str, lat: dict) -> dict:
    """The innermost loop with the longest critical path (``walk``)."""
    instrs = parse(sass)
    best = None
    for first, last in loops(instrs):
        loop = walk(instrs, first, last, lat)
        if best is None or loop["cycles"] > best["cycles"]:
            best = loop
    if best is None:
        raise ValueError("no loop in this SASS")
    return best


def step_loops(sass: str, lat: dict, is_back=None) -> list:
    """``walk`` of each outermost loop (``outer_loops``), in address order
    (a kernel whose warps split a step between them has a loop of steps for
    each)."""
    instrs = parse(sass)
    found = [walk(instrs, first, last, lat) for first, last in outer_loops(instrs, is_back)]
    if not found:
        raise ValueError("no loop in this SASS")
    return found


def census(path: list, part_of) -> dict:
    """Instructions of a walk by part: ``part_of(Instr) -> str`` names the
    part an instruction belongs to (by its source line, say)."""
    out = {}
    for ins in path:
        part = part_of(ins)
        out[part] = out.get(part, 0) + 1
    return out


def issue_ms(count: float, steps: int, warps: int, sms: int, clock_mhz: float,
             schedulers: int = 4) -> float:
    """The least time ``warps`` warps take to issue ``steps`` walks of
    ``count`` instructions each, spread over ``sms`` SMs of ``schedulers``
    schedulers that each issue one instruction a cycle."""
    return count * steps * warps / (schedulers * sms * clock_mhz * 1e3)


def cuobjdump() -> str:
    from covo_mpc_tpu_torch.ops import kernels

    return str(Path(kernels._nvcc()).with_name("cuobjdump"))


@functools.lru_cache(maxsize=None)
def _sass_listing(lib: str) -> str:
    """``cuobjdump -sass`` of a built library (a process builds each library
    once, so one listing serves every function asked of it)."""
    return subprocess.run([cuobjdump(), "-sass", lib], capture_output=True, text=True,
                          check=True).stdout


def function_sass(lib: Path, name: str) -> str:
    """The SASS of the one function in ``lib`` whose mangled name holds
    ``name`` (e.g. "sens_chain_kernelILi13E", "primal_kernel")."""
    out = _sass_listing(str(lib))
    parts = re.split(r"\n\s*Function : (\S+)\n", out)
    found = [(fn, body) for fn, body in zip(parts[1::2], parts[2::2]) if name in fn]
    if len(found) != 1:
        raise ValueError(f"{len(found)} functions match {name!r} in {lib}")
    return found[0][1]


def lined_sass(lib: Path, out_dir: Path) -> dict:
    """Every function of ``lib`` (built with ``-lineinfo``) as ``nvdisasm -g
    -hex`` prints it: the innermost source line before each group of
    instructions, and each instruction's encoding (so its stall count).
    The cubin is extracted into ``out_dir``, and the whole listing kept
    there as ``<lib name>.sass``. Returns mangled name -> SASS."""
    import tempfile

    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        subprocess.run([cuobjdump(), "-xelf", "all", str(Path(lib).resolve())], cwd=tmp,
                       capture_output=True, text=True, check=True)
        cubins = sorted(Path(tmp).glob("*.cubin"))
        if not cubins:
            raise ValueError(f"no cubin in {lib}")
        text = "".join(subprocess.run(
            [str(Path(cuobjdump()).with_name("nvdisasm")), "-g", "-hex", "-c", str(c)],
            capture_output=True, text=True, check=True).stdout for c in cubins)
    (out_dir / f"{Path(lib).stem}.sass").write_text(text)
    parts = re.split(r"\n//-+ \.text\.(\S+) -+\n", text)
    return dict(zip(parts[1::2], parts[2::2]))


def build_probe(out_dir: Path) -> Path:
    """Compile ``latency_probe.cu`` into a library under ``out_dir``."""
    from covo_mpc_tpu_torch.ops import kernels

    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "latency_probe.so"
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(lib),
                           str(Path(__file__).with_name("latency_probe.cu"))],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on latency_probe.cu:\n{proc.stdout}{proc.stderr}")
    return lib


def load_probe(lib: Path) -> ctypes.CDLL:
    """The built probe library, its entry points bound."""
    cdll = ctypes.CDLL(str(lib))
    cdll.latency_probe.argtypes = [ctypes.c_void_p] * 4
    cdll.latency_probe.restype = ctypes.c_int
    cdll.empty_launch.argtypes = [ctypes.c_void_p]
    cdll.empty_launch.restype = ctypes.c_int
    return cdll


def measure_latencies(probe: ctypes.CDLL) -> dict:
    """Run the latency probe (``load_probe``) on the current card: cycles of
    a dependent issue by class, and the SM clock the probe ran at
    ("sm_mhz": its cycles over the global timer's ns)."""
    import torch

    ring = torch.empty(16 * 64, dtype=torch.int64, device="cuda")
    sink = torch.empty(32, device="cuda")
    out = torch.zeros(8, dtype=torch.float64, device="cuda")
    err = probe.latency_probe(ring.data_ptr(), sink.data_ptr(), out.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"latency_probe: CUDA launch failed, cudaError {err}")
    ffma, imad, rsq, rcp, lds, shfl, ldg, mhz = out.tolist()
    return {"fp32": ffma, "int": imad, "mufu": max(rsq, rcp), "mufu.rsq": rsq,
            "mufu.rcp": rcp, "lds": lds, "shfl": shfl, "ldg": ldg, "sm_mhz": mhz}


def chain_ms(steps: int, cycles: float, clock_mhz: float) -> float:
    """The least time of ``steps`` dependent steps of ``cycles`` each at an
    SM clock of ``clock_mhz``."""
    return steps * cycles / (clock_mhz * 1e3)


def describe(loop: dict) -> str:
    """One line: cycles a step, the path's length and its opcodes."""
    ops = {}
    for ins in loop["chain"]:
        ops[ins.opcode] = ops.get(ins.opcode, 0) + 1
    return (f"{loop['cycles']:.1f} cycles a step over {len(loop['chain'])} dependent "
            f"instructions of {loop['body']} (issue {loop['issue']} cycles) in the loop at "
            f"{loop['range'][0]:#x}-"
            f"{loop['range'][1]:#x} ({', '.join(f'{k} {v}' for k, v in ops.items())})")
