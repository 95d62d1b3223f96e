from emfusion_tpu_torch.eval.ate import evaluate_ate

__all__ = ["evaluate_ate"]
