"""Ports of the JAX package's tools (`tools/*.py`), each run as
`python -m posecnn_torch.tools.<name>`: `diag_rot`, `isolate_pose`,
`supervise_train`, `check_data`, `test_icp`, `test_synthesis`,
`render_poses`; `eval_checkpoint.sh` runs the evaluation battery."""
