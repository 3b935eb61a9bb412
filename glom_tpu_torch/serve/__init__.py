from glom_tpu_torch.serve.engine import InferenceEngine, ServeResult

__all__ = ["InferenceEngine", "ServeResult"]
