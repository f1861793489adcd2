"""The vanilla chains: the point DPM and the latent diffusions.

Port of ``difffacto_tpu/models/diffusion_extra.py``. Each is a configured
``AnchoredDiffusion``: anchors pinned to zero (``learn_anchor=False``),
``k=1``, no learned variance, no anchors in the net's input, so the schedule
and posterior math is the one of the flagship chain. ``PointDiffusion`` is
the reference's vanilla DDPM over point clouds, ``LDM`` the same process on
(B, K, zdim) part codes, ``LatentDiffusionDrift`` the latter with guidance
at ``classifier_weight`` where it is not 1 (the shipped drift chain is
vanilla: the prior only conditions the net).
"""

from __future__ import annotations

from ..utils.registry import DIFFUSIONS
from .diffusion import AnchoredDiffusion


def _vanilla(num_timesteps, beta_1, beta_T, mode, use_beta, rescale_timesteps, loss_type,
             model_mean_type, model_var_type, scale_loss, net, **extra) -> AnchoredDiffusion:
    return AnchoredDiffusion(
        num_timesteps=num_timesteps, beta_1=beta_1, beta_T=beta_T, k=1.0, res=False, mode=mode,
        use_beta=use_beta, rescale_timesteps=rescale_timesteps, loss_type=loss_type,
        model_mean_type=model_mean_type, model_var_type=model_var_type, scale_loss=scale_loss,
        include_anchors=False, learn_anchor=False, learn_variance=False, net=net, **extra)


@DIFFUSIONS.register_module()
def PointDiffusion(net=None, num_timesteps: int = 100, beta_1: float = 1e-4, beta_T: float = 0.02,
                   mode: str = "linear", use_beta: bool = True, rescale_timesteps: bool = False,
                   loss_type: str = "mse", model_mean_type: str = "epsilon",
                   model_var_type: str = "fixed_small", scaled_loss: bool = False,
                   include_global_latent: bool = False, include_anchor_latent: bool = True,
                   include_anchors: bool = False) -> AnchoredDiffusion:
    """The vanilla point DPM (``diffusion_extra.py:47-69``)."""
    return _vanilla(num_timesteps, beta_1, beta_T, mode, use_beta, rescale_timesteps, loss_type,
                    model_mean_type, model_var_type, scaled_loss, net)


@DIFFUSIONS.register_module()
def LDM(net=None, num_timesteps: int = 100, beta_1: float = 1e-4, beta_T: float = 0.02,
        mode: str = "linear", use_beta: bool = True, rescale_timesteps: bool = False,
        loss_type: str = "mse", model_mean_type: str = "epsilon",
        model_var_type: str = "fixed_small", **_) -> AnchoredDiffusion:
    """Latent diffusion over part codes (``diffusion_extra.py:72-90``)."""
    return _vanilla(num_timesteps, beta_1, beta_T, mode, use_beta, rescale_timesteps, loss_type,
                    model_mean_type, model_var_type, False, net)


@DIFFUSIONS.register_module()
def LatentDiffusionDrift(net=None, num_timesteps: int = 100, beta_1: float = 1e-4,
                         beta_T: float = 0.02, mode: str = "linear", use_beta: bool = False,
                         rescale_timesteps: bool = False, loss_type: str = "mse",
                         model_mean_type: str = "epsilon", model_var_type: str = "fixed_small",
                         classifier_weight: float = 1.0, **_) -> AnchoredDiffusion:
    """The drift chain (``diffusion_extra.py:93-132``): vanilla, with
    classifier-free guidance where ``classifier_weight`` is not 1; its own
    ``use_beta`` default is False."""
    return _vanilla(num_timesteps, beta_1, beta_T, mode, use_beta, rescale_timesteps, loss_type,
                    model_mean_type, model_var_type, False, net,
                    guidance=classifier_weight != 1.0, classifier_weight=classifier_weight)
