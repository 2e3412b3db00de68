#!/usr/bin/env bash
# Search/eval sweep on T2I-10M through the PyTorch port's CLI, on the card
# (twin of run_roargraph_search_test.sh; counterpart of the reference's
# run_roargraph_search_test.sh:1-15: k=10, L_pq sweep 10..2000, CSV out).
set -euo pipefail
data=${DATA_DIR:-data}/t2i-10M

python -m mysteryann_tpu_torch.cli.search_roargraph \
  --data_type float --dist ip \
  --base_data_path "$data/base.10M.fbin" \
  --query_path "$data/query.10k.fbin" \
  --gt_path "$data/gt.10k.ibin" \
  --projection_index_save_path "$data/t2i_10M_roar.index" \
  --k 10 \
  --L_pq 10 20 30 40 50 60 70 80 90 100 120 140 160 180 200 250 300 350 \
         400 450 500 550 600 650 700 750 800 850 900 950 1000 1100 1200 \
         1300 1400 1500 1600 1700 1800 1900 2000 \
  --csv_path "$data/t2i_10M_search.csv"
