"""The applications of the port: knpemidg_tpu's examples/ drivers on the
card (python -m knpemidg_tpu_torch.apps.run_2D, ...).  Each build_solver
takes ``device`` ("cuda" unless the caller names another); H5 output is
not ported, so no main() writes field or stats files."""
