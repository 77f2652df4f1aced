from diffute_tpu_torch.pipeline.edit import DiffUTEPipeline, text_editing

__all__ = ["DiffUTEPipeline", "text_editing"]
