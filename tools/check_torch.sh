#!/usr/bin/env bash
# Pre-merge gate of the PyTorch/CUDA port (mythril_tpu_torch), in the style
# of tools/check.sh: tpu-lint, the port's cfaview, then the port's serving
# smokes against its daemon, each under its own time limit.
#
#     tools/check_torch.sh            # every stage, on the CPU
#     tools/check_torch.sh --lint     # lint only
#
# The daemons run the host engine and the CDCL, which need no card; the
# warm smoke runs K11's plain twin (--device cpu). Exits non-zero on the
# first failing stage. The load flow on the card is
# `python3 chip_smoke.py --load`.

set -u -o pipefail
cd "$(dirname "$0")/.."

echo "== tpu-lint =="
python -m tools.lint || exit $?

if [ "${1:-}" = "--lint" ]; then
    exit 0
fi

echo
echo "== torch cfaview (the port's static analysis on the vendored killbilly) =="
timeout -k 10 120 python -m tools.torch_cfaview killbilly > /dev/null \
    || exit $?

echo
echo "== torch serve smoke (daemon start -> request -> metrics scrape -> clean shutdown) =="
timeout -k 10 180 python -m tools.torch_serve_smoke || exit $?

echo
echo "== torch chaos smoke (worker segv/hang injection -> retry -> quarantine) =="
timeout -k 10 600 python -m tools.torch_chaos_smoke || exit $?

echo
echo "== torch warm smoke (cold first runs + persist -> fresh process respawns warm) =="
timeout -k 10 400 python -m tools.torch_warm_smoke --device cpu || exit $?

echo
echo "== torch load smoke (open-loop overload: 0 interactive shed + autoscale-up + result-store hit) =="
timeout -k 10 600 python -m tools.torch_load_smoke || exit $?
