"""The ``card`` marker: a test that needs a CUDA device skips at run time
where there is none (never while the module is imported)."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skipped without one)")


@pytest.fixture(autouse=True)
def _card(request):
    if request.node.get_closest_marker("card"):
        import torch
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device; run on the card with "
                        "`python3 -m pytest bench/tests -m card`")
