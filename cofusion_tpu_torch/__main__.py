from cofusion_tpu_torch.cli import run

raise SystemExit(run())
