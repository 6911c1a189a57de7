"""Differentiable rendering: gradients to material parameters and their
checks (port of `optixpathtracer_tpu/diff`)."""
from .gradcheck import (DIFF_FIELDS, finite_difference,  # noqa: F401
                        param_gradients, render_loss_fn)
