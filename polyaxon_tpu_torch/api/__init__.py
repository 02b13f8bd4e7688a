from polyaxon_tpu_torch.api.app import create_app, run_to_dict, serve

__all__ = ["create_app", "run_to_dict", "serve"]
