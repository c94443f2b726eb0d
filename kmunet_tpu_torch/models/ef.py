"""Encoder-forecaster recurrent baselines: ConvLSTM and TrajGRU (port of
``kmunet_tpu/models/ef.py``).

Architecture (both models; the strides give these sizes at 128^2 input):
  encoder   conv(1->8,k6,s4,p1)+leaky -> RNN@32^2 -> conv(64->192,k4,s4,p1)
            -> RNN@8^2 -> conv(192->192,k3,s2,p1) -> RNN@4^2
  forecaster RNN@4^2 -> deconv(192->192,k4,s2,p1) -> RNN@8^2 ->
            deconv(192->64,k6,s4,p1) -> RNN@32^2 ->
            deconv(64->8,k6,s4,p1)+conv(8->8)+conv(8->1)

Tensors are NCHW inside. The JAX package's ``nn.scan`` over time becomes a
Python loop over one cell module per RNN: the scan broadcasts its
parameters, so every step uses the same ones, and the module names match
the flax ones (``enc_rnn1.ret.weight`` is flax's ``enc_rnn1/ret/kernel``).
The forecaster starts from the encoder's last states s3, s2, s1 and its
first RNN takes no input (TrajGRU: no input convs at all; ConvLSTM: zeros).

TrajGRU's warp samples the state at L flow fields in one multiview gather
(``ops/sample.py::bilinear_gather_multiview``: K7 on a CUDA tensor), with
the coordinates built in the state's dtype as the JAX package builds them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from kmunet_tpu_torch.nn.init import kaiming_uniform_
from kmunet_tpu_torch.ops.sample import bilinear_gather_multiview


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def conv(in_channels: int, features: int, kernel: int, stride: int, padding: int) -> nn.Conv2d:
    return nn.Conv2d(in_channels, features, kernel, stride, padding)


def conv_t(in_channels: int, features: int, kernel: int, stride: int,
           padding: int) -> nn.ConvTranspose2d:
    """torch ConvTranspose2d(k, s, p): out = (in-1)*s - 2p + k. flax's
    ``ConvTranspose(transpose_kernel=True)`` with padding k-1-p computes the
    same; its kernel (kh, kw, out, in) is this weight (in, out, kh, kw)
    with no spatial flip."""
    return nn.ConvTranspose2d(in_channels, features, kernel, stride, padding)


class ConvLSTMCell(nn.Module):
    """Peephole ConvLSTM cell with per-channel peepholes ``Wci``, ``Wcf``,
    ``Wco`` (zero at init)."""

    def __init__(self, in_channels: int, filters: int):
        super().__init__()
        self.filters = filters
        self.conv = conv(in_channels + filters, 4 * filters, 3, 1, 1)
        self.Wci = nn.Parameter(torch.zeros(filters))
        self.Wcf = nn.Parameter(torch.zeros(filters))
        self.Wco = nn.Parameter(torch.zeros(filters))

    def forward(self, carry, x: torch.Tensor):
        h, c = carry
        i, f, g, o = self.conv(torch.cat([x, h], 1)).chunk(4, 1)
        peep = lambda w: w.view(1, -1, 1, 1)  # noqa: E731
        i = torch.sigmoid(i + peep(self.Wci) * c)
        f = torch.sigmoid(f + peep(self.Wcf) * c)
        c = f * c + i * torch.tanh(g)
        o = torch.sigmoid(o + peep(self.Wco) * c)
        return o * torch.tanh(c), c


def warp_coordinates(flows: torch.Tensor, views: int, dtype: torch.dtype):
    """The sampling coordinates of TrajGRU's warp, x and y (B, L, H, W):
    ``arange - flow`` for each of L flow fields. ``flows`` (B, 2L, H, W)
    holds view l's x-flow at channel 2l and its y-flow at 2l+1. The grid is
    built in ``dtype`` (the state's) and the subtraction runs in the
    promoted dtype, as the JAX package does: in bf16 that rounds the
    coordinates to bf16 (0.125 px apart at 16-31 px)."""
    B, _, H, W = flows.shape
    fl = flows.view(B, views, 2, H, W)
    xx = torch.arange(W, dtype=dtype, device=flows.device)
    yy = torch.arange(H, dtype=dtype, device=flows.device).view(H, 1)
    return xx - fl[:, :, 0], yy - fl[:, :, 1]


class TrajGRUCell(nn.Module):
    """Flow-warping GRU cell over L flow fields; the warped state goes
    through a 1x1 conv (``ret``). ``use_input=False`` has no input convs
    (``i2f_conv1``, ``i2h``) and no input term, biases included."""

    def __init__(self, in_channels: int, filters: int, L: int = 5, use_input: bool = True):
        super().__init__()
        self.filters, self.L, self.use_input = filters, L, use_input
        self.h2f_conv1 = conv(filters, 32, 5, 1, 2)
        if use_input:
            self.i2f_conv1 = conv(in_channels, 32, 5, 1, 2)
            self.i2h = conv(in_channels, 3 * filters, 3, 1, 1)
        self.flows_conv = conv(32, 2 * L, 5, 1, 2)
        self.ret = nn.Conv2d(L * filters, 3 * filters, 1)

    def forward(self, h: torch.Tensor, x: Optional[torch.Tensor] = None) -> torch.Tensor:
        f = self.h2f_conv1(h)
        if self.use_input:
            f = f + self.i2f_conv1(x)
        flows = self.flows_conv(leaky(f))
        vx, vy = warp_coordinates(flows, self.L, h.dtype)
        # One gather of the NHWC state at all L flow fields -> (B, H, W, L*C),
        # view l in channel block l; ``ret`` (1x1) reads it on the last axis.
        warped = bilinear_gather_multiview(
            h.permute(0, 2, 3, 1).contiguous(), vx.float().contiguous(),
            vy.float().contiguous(), padding_mode="zeros")
        h2h = F.linear(warped, self.ret.weight.flatten(1), self.ret.bias).permute(0, 3, 1, 2)
        hr, hu, hm = h2h.chunk(3, 1)
        if self.use_input:
            ir, iu, im = self.i2h(x).chunk(3, 1)
            reset = torch.sigmoid(ir + hr)
            update = torch.sigmoid(iu + hu)
            new_mem = leaky(im + reset * hm)
        else:
            reset = torch.sigmoid(hr)
            update = torch.sigmoid(hu)
            new_mem = leaky(reset * hm)
        return update * h + (1 - update) * new_mem


class _EF(nn.Module):
    """Shared encoder-forecaster scaffold; ``cell`` is 'convlstm' or
    'trajgru'. ``forward`` maps (B, S, H, W) input frames to (B, out_frames,
    H, W)."""

    cell = "convlstm"
    # (filters, L) per level, the JAX package's widths; L only for trajgru.
    # (Its specs also carry an h2h kernel size that nothing reads.)
    ENC_RNN = ((64, 13), (192, 13), (192, 9))
    FORE_RNN = ((192, 13), (192, 13), (64, 9))

    def __init__(self, out_frames: int = 20):
        super().__init__()
        self.out_frames = out_frames
        self.enc_stage1 = conv(1, 8, 6, 4, 1)
        self.enc_rnn1 = self._cell(self.ENC_RNN[0], 8)
        self.enc_stage2 = conv(64, 192, 4, 4, 1)
        self.enc_rnn2 = self._cell(self.ENC_RNN[1], 192)
        self.enc_stage3 = conv(192, 192, 3, 2, 1)
        self.enc_rnn3 = self._cell(self.ENC_RNN[2], 192)
        # The first forecaster RNN has no input: TrajGRU drops the input
        # convs, ConvLSTM takes 192 zero channels.
        self.fore_rnn3 = self._cell(self.FORE_RNN[0], 192, use_input=False)
        self.fore_stage3 = conv_t(192, 192, 4, 2, 1)
        self.fore_rnn2 = self._cell(self.FORE_RNN[1], 192)
        self.fore_stage2 = conv_t(192, 64, 6, 4, 1)
        self.fore_rnn1 = self._cell(self.FORE_RNN[2], 64)
        self.fore_stage1_deconv = conv_t(64, 8, 6, 4, 1)
        self.fore_stage1_conv1 = conv(8, 8, 3, 1, 1)
        self.fore_stage1_conv2 = nn.Conv2d(8, 1, 1)

    def _cell(self, spec, in_channels: int, use_input: bool = True) -> nn.Module:
        filters, L = spec
        if self.cell == "convlstm":
            return ConvLSTMCell(in_channels, filters)
        return TrajGRUCell(in_channels, filters, L=L, use_input=use_input)

    def _zero_state(self, rnn: nn.Module, ref: torch.Tensor):
        h = ref.new_zeros(ref.shape[0], rnn.filters, *ref.shape[2:])
        return (h, h) if self.cell == "convlstm" else h

    def _run(self, rnn: nn.Module, state, xs: Sequence[Optional[torch.Tensor]]):
        """Steps ``rnn`` over ``xs`` from ``state``; (B*T, C, H, W) of the
        outputs, batch-major, and the last state."""
        ys = []
        for x in xs:
            state = rnn(state, x)
            ys.append(state[0] if self.cell == "convlstm" else state)
        return torch.stack(ys, 1).flatten(0, 1), state

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, H, W = x.shape
        T = self.out_frames

        def frames(y, n):  # (B*n, C, h, w) -> n tensors (B, C, h, w)
            return y.view(B, n, *y.shape[1:]).unbind(1)

        # ---- encoder ----
        e = frames(leaky(self.enc_stage1(x.reshape(B * S, 1, H, W))), S)
        y, s1 = self._run(self.enc_rnn1, self._zero_state(self.enc_rnn1, e[0]), e)
        y = frames(leaky(self.enc_stage2(y)), S)
        y, s2 = self._run(self.enc_rnn2, self._zero_state(self.enc_rnn2, y[0]), y)
        y = frames(leaky(self.enc_stage3(y)), S)
        _, s3 = self._run(self.enc_rnn3, self._zero_state(self.enc_rnn3, y[0]), y)

        # ---- forecaster (rnn3 -> rnn1) ----
        if self.cell == "convlstm":  # the reference feeds zeros for the missing input
            xs = [s3[0].new_zeros(B, 192, *s3[0].shape[2:])] * T
        else:
            xs = [None] * T
        d, _ = self._run(self.fore_rnn3, s3, xs)
        d = frames(leaky(self.fore_stage3(d)), T)
        d, _ = self._run(self.fore_rnn2, s2, d)
        d = frames(leaky(self.fore_stage2(d)), T)
        d, _ = self._run(self.fore_rnn1, s1, d)
        d = leaky(self.fore_stage1_deconv(d))
        d = leaky(self.fore_stage1_conv1(d))
        return self.fore_stage1_conv2(d).reshape(B, T, H, W)


class ConvLSTM_EF(_EF):
    cell = "convlstm"


class TrajGRU_EF(_EF):
    cell = "trajgru"


def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation with the JAX package's distributions: every
    conv and transposed conv weight PyTorch's default kaiming-uniform (fan-in
    counted as flax counts it for its kernel), the biases and ConvLSTM's
    peepholes zero."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            kaiming_uniform_(m.weight, generator)
            if m.bias is not None:
                m.bias.detach().zero_()
        elif isinstance(m, ConvLSTMCell):
            for p in (m.Wci, m.Wcf, m.Wco):
                p.detach().zero_()
    return model
