#!/usr/bin/env bash
# CI gate: lint + compile + unit tests (the analogue of the reference's
# check_clang_format workflow + ctest; .github/workflows/, CMakeLists.txt).
# Usage: ./ci.sh            (CPU: lint + tests)
#        ./ci.sh --gpu      (additionally runs chip_smoke.py on the GPU)
set -euo pipefail
cd "$(dirname "$0")"

echo "== lint =="
if command -v ruff >/dev/null 2>&1; then
  ruff check .
else
  python scripts/lint.py
fi

echo "== compile =="
python -m compileall -q portfft_tpu tests scripts bench.py chip_smoke.py __graft_entry__.py

echo "== unit tests (CPU, 8-device virtual mesh) =="
python -m pytest tests/ -q

if [[ "${1:-}" == "--gpu" ]]; then
  echo "== on-card smoke test =="
  python chip_smoke.py
fi

echo "CI OK"
