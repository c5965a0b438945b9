from kmbart_tpu_torch.eval.metrics import compute_metric_inference, use_same_id  # noqa: F401
