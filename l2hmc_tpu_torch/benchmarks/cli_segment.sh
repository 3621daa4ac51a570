#!/bin/bash
# One segment of a long CLI run on the card: the README's canonical 8x8
# command and/or its topological quick start through
# `python -m l2hmc_tpu_torch.cli.train_gauge`, each stopped by SIGTERM after
# SECONDS (the CLI checkpoints on it) and resumed with --restore from the
# newest run dir under build/accept/<name> when one is there.  Each
# command's newest run dir comes back under chiprun_out/accept/<name> with
# its checkpoints pruned to the newest by (training attempt, step) (three
# checkpoints of the 8x8 conv nets are too large to copy back each
# segment).  Copy it back under
# build/accept/<name>/ before the next segment.  A run dir with eval
# files gets analysis.json (the port's analyze_run) on the card.
# CARD_TESTS=<pattern> also runs the matching tests of
# tests/test_torch_kernels.py meanwhile.
#
# usage: bash l2hmc_tpu_torch/benchmarks/cli_segment.sh SECONDS [canonical] [topo]
T=$1; shift
mkdir -p build/accept chiprun_out/accept
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee build/accept/smi.txt
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
CANON="--space_size 8 --time_size 8 --num_samples 128 --num_steps 3 --eps 0.35 --beta_init 2 --beta_final 4 --train_steps 5000"
TOPO="--time_size 16 --space_size 16 --num_samples 128 --num_steps 4 --eps 0.079 --eps_fixed --network_arch mlp --num_hidden 64 --merge_v_halves --charge_reward --train_hops --beta_final 5.0 --train_steps 12000 --retrain_acc 0.7 --eval_hops 1 --run_steps 8000 --eval_init metropolis"
seg=$(date +%s)
for which in "$@"; do
  if [ "$which" = canonical ]; then ARGS=$CANON; else ARGS=$TOPO; fi
  R=""; [ -d build/accept/$which ] && R="--restore"
  (timeout -s TERM $T python -m l2hmc_tpu_torch.cli.train_gauge $ARGS --log_dir build/accept/$which $R > build/accept/${which}_$seg.log 2>&1; echo "exit $?" >> build/accept/${which}_$seg.log) &
done
if [ -n "$CARD_TESTS" ]; then
  python -m pytest tests/test_torch_kernels.py --noconftest -q -k "$CARD_TESTS" > build/accept/card_tests_$seg.log 2>&1
  tail -15 build/accept/card_tests_$seg.log
fi
wait
for which in "$@"; do
  tail -8 build/accept/${which}_$seg.log
  newest=$(ls -d build/accept/$which/run_* | sort -t_ -k2 -n | tail -1)
  if ls $newest/eval_beta*.npz > /dev/null 2>&1; then
    python -m l2hmc_tpu_torch.cli.analyze_run $newest > build/accept/${which}_analysis_$seg.log 2>&1
    tail -6 build/accept/${which}_analysis_$seg.log
    cp build/accept/${which}_analysis_$seg.log chiprun_out/accept/
  fi
  mkdir -p chiprun_out/accept/$which
  cp -r $newest chiprun_out/accept/$which/
  out=chiprun_out/accept/$which/$(basename $newest)/checkpoints
  # checkpoint dirs are <step> (attempt 0) or attempt<a>_<step>: keep the
  # newest by (attempt, step)
  ckpts=$(ls $out | grep -E '^([0-9]+|attempt[0-9]+_[0-9]+)$')
  last=$(for d in $ckpts; do echo "$d" | sed -E 's/^attempt([0-9]+)_([0-9]+)$/\1 \2 &/; t; s/^([0-9]+)$/0 \1 &/'; done | sort -k1,1n -k2,2n | tail -1 | cut -d' ' -f3)
  for d in $ckpts; do [ "$d" = "$last" ] || rm -rf $out/$d; done
  cp build/accept/${which}_$seg.log chiprun_out/accept/
  # keep the returned directory under 64 MiB: a long eval's traces (the
  # quick start: 2 x 8000 transitions of 128 chains) can pass it;
  # analysis.json stays
  if [ $(du -sm chiprun_out | cut -f1) -gt 48 ]; then
    rm -f chiprun_out/accept/$which/$(basename $newest)/eval_beta*.npz
  fi
done
cp build/accept/*.txt build/accept/card_tests_*.log chiprun_out/accept/ 2>/dev/null
du -sh chiprun_out
