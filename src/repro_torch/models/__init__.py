from repro_torch.models import api  # noqa: F401
