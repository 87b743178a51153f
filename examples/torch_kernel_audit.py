#!/usr/bin/env python3
"""What the field product issues: SASS counts beside the model.

    python3 examples/torch_kernel_audit.py

Builds the package's kernels (csrc/*.cu) and counts the integer
multiply-add instructions in the SASS (`cuobjdump -sass`) of binop_kernel
(Montgomery product, Fr) and of point_add_kernel, beside the model count
of 264 a product that chip_smoke.py's bounds use, and the time each count
takes on 10^6 elements at the card's integer rate.  The field product of
the point formulas is not inlined (csrc/point.cuh), so point_add_kernel's
listing holds one product body that its 12 products call: a static count,
not a count per point.  Registers, stack and blocks per SM of the point kernels are in
chip_smoke.py's `env` and `kernels` lines.  `code` gives the size in SASS
instructions of the chain kernels of the batch inversion (Fr): inv_kernel,
pow_kernel, scan_kernel at each run length V and the scan's product
scan_mul, where the tree has them.
Prints one JSON line.  Needs one CUDA device and the CUDA toolkit.
"""

import argparse
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from halo2_tpu_torch.utils import build, profiling  # noqa: E402

MADS_PER_PRODUCT = 264
PRODUCTS = {"add": 12}


def sass_counts(lib_path: str, patterns: dict) -> dict:
    """Instruction counts in the SASS of the functions whose mangled name
    contains each pattern: IMAD-class (every IMAD variant), IMAD.MOV (moves
    on the multiply-add pipe), and all instructions."""
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = next((k for k, pat in patterns.items()
                            if pat in m.group(1)), None)
            if current:
                counts[current] = {"imad": 0, "imad_mov": 0, "all": 0}
            continue
        ins = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                        line)
        if current and ins:
            op = ins.group(1)
            c = counts[current]
            c["all"] += 1
            if op.startswith("IMAD"):
                c["imad"] += 1
                if op.startswith("IMAD.MOV"):
                    c["imad_mov"] += 1
    return counts


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]) \
        .parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_audit: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build.build_all()
    rate = profiling.card_int_rate()
    sass = sass_counts(build.load("field_kernels")._name,
                       {"binop_mul_fr": "binop_kernelILi2ELi0E"})
    sass.update(sass_counts(build.load("point_kernels")._name,
                            {"point_add": "point_add_kernel"}))
    per_point = {"binop_mul_fr": 1, "point_add": PRODUCTS["add"]}
    audit = {}
    for name, c in sass.items():
        model = MADS_PER_PRODUCT * per_point[name]
        audit[name] = {**c, "model_mads": model,
                       "ns_per_1e6_elements_at_sass_imad":
                           c["imad"] * 1e6 / rate["mad_per_s"] * 1e9,
                       "ns_per_1e6_elements_at_model":
                           model * 1e6 / rate["mad_per_s"] * 1e9}
    code = sass_counts(build.load("field_kernels")._name, {
        "inv_kernel_fr": "inv_kernelILi0E",
        "pow_kernel_fr": "pow_kernelILi0E",
        "scan_mul_fr": "scan_mulILi0E",
        **{f"scan_kernel_fr_v{v}": f"scan_kernelILi0ELi{v}E"
           for v in (1, 2, 4, 8)}})
    print(json.dumps({"kernel_audit": {
        "card": smi, "int_rate": rate, "sass": audit,
        "code": {name: c["all"] for name, c in code.items()}}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
