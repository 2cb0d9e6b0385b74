from uce_tpu_torch.serving.server import GenerationServer, ServerConfig

__all__ = ["GenerationServer", "ServerConfig"]
