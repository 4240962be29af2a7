from repro_torch.models.model import NUM_FRONTEND_POSITIONS, Model

__all__ = ["Model", "NUM_FRONTEND_POSITIONS"]
