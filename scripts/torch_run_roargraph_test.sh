#!/usr/bin/env bash
# Build the RoarGraph index on T2I-10M with the reference's paper
# configuration (reference run_roargraph_test.sh:5-10: M_sq=100,
# M_pjbp=35, L_pjpq=500) through the PyTorch port's CLIs, on the card
# (twin of run_roargraph_test.sh, which runs the JAX package's). The exact
# train->base kNN build input is computed by the port's compute_gt instead
# of by external DiskANN utilities; an existing $data/learn.base.nn.ibin is
# reused.
set -euo pipefail
data=${DATA_DIR:-data}/t2i-10M

python -m mysteryann_tpu_torch.cli.prepare_data t2i-10M --data_dir "${DATA_DIR:-data}"

if [ ! -e "$data/learn.base.nn.ibin" ]; then
  python -m mysteryann_tpu_torch.cli.compute_gt \
    --base_data_path "$data/base.10M.fbin" \
    --query_path "$data/query.train.10M.fbin" \
    --k 100 --dist ip --format knn \
    --out_path "$data/learn.base.nn.ibin"
fi

python -m mysteryann_tpu_torch.cli.build_roargraph \
  --data_type float --dist ip \
  --base_data_path "$data/base.10M.fbin" \
  --sampled_query_data_path "$data/query.train.10M.fbin" \
  --learn_base_nn_path "$data/learn.base.nn.ibin" \
  --projection_index_save_path "$data/t2i_10M_roar.index" \
  --M_sq 100 --M_pjbp 35 --L_pjpq 500
