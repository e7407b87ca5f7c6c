#!/bin/bash
# A/B of the PyTorch port's paged decode kernels on one CUDA card: the
# paged-decode checks and times of chip_smoke.py (check_decode; and
# check_decode_split where the tree has it), run in two trees in turns,
# A, B, B, A, one process each, so that both versions meet the same card.
# Each process builds its tree's kernels and prints their ptxas lines.
#
#   git archive <commit> | tar -x -C build/parent   # a listed directory
#   scripts/torch_decode_ab.sh build/parent          # from the repo root
#
# Arguments: tree A (e.g. the parent commit), and tree B (default: the
# current directory).
set -o pipefail
A=$(cd "${1:?usage: $0 TREE_A [TREE_B]}" && pwd)
B=$(cd "${2:-.}" && pwd)
run() {  # $1 = label, $2 = tree
  (cd "$2" && python3 -c "
import chip_smoke as c, torch
c.phase_device(); c.phase_build()
g = torch.Generator('cuda'); g.manual_seed(0)
_, t = c.check_decode(g)
print('$1 fused decode ms', {k: round(v['ms'], 5) for k, v in t.items()},
      flush=True)
if hasattr(c, 'check_decode_split'):
    _, t = c.check_decode_split(g)
    print('$1 split decode ms (fused kernel on the same pools)',
          {k: (round(v['ms'], 5), round(v['fused_kernel_same_pool_ms'], 5))
           for k, v in t.items()}, flush=True)
")
}
run A1 "$A" && run B1 "$B" && run B2 "$B" && run A2 "$A"
