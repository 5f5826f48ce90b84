"""LSTM language models (counterpart of ``fedml_tpu/models/rnn.py``),
fp32 as in the reference.

- :class:`RNNOriginalFedAvg`: an 8-d embedding (vocab 90), two LSTMs of
  256 and a dense head; ``output_all_timesteps=False`` predicts from the
  last step's hidden state (``[B, V]``), ``True`` gives every step's
  logits (``[B, T, V]``).
- :class:`RNNStackOverflow`: vocabulary ``V + 3 + num_oov_buckets``
  (10,004 rows at V 10,000), a 96-d embedding, an LSTM of 670, a 96-d
  projection and the head over the extended vocabulary.

The LSTM is flax's ``OptimizedLSTMCell`` written out: gates i, f, g, o;
input kernels without a bias and hidden kernels with one; ``c = f*c +
i*g``, ``h = o*tanh(c)`` with sigmoid gates, the carry starting at 0.
``torch.nn.LSTM`` cannot take a weight set per client, so the step is
two batched products over the client axis: the input projection of all T
steps at once (``[in, 4H]``), then one ``[H, 4H]`` product a step
(``torch.baddbmm`` over ``[K, B, H]``). These are plain products in the
reference too (XLA, no Pallas), so no kernel is written for them.

The modules hold their parameters under torch names, a layer's four gate
kernels concatenated in i, f, g, o order and stored ``[out, in]`` as
``nn.Linear`` stores them: ``lstm{j}.weight_ih [4H, in]``,
``lstm{j}.weight_hh [4H, H]``, ``lstm{j}.bias_hh [4H]``; the embeddings
``<name>.weight [V, E]`` and the dense layers ``<name>.weight [out, in]``
and ``.bias``. ``utils/torch_import.py`` carries flax's variables
across. :meth:`apply_params` takes one model's parameters or K clients'
stacked on a leading axis (then the tokens are ``[K, B, T]``), as
:class:`~fedml_tpu_torch.models.transformer.TransformerLM` does, so the
sequence spec trains them.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from fedml_tpu_torch.models.transformer import dense, embed

_TRUNC = .87962566103423978  # std of a unit normal truncated at 2 sigma


def _lecun_(w, fan_in, generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


class LSTMLayer(nn.Module):
    """Parameters of one ``OptimizedLSTMCell`` of ``hidden`` units."""

    def __init__(self, in_features, hidden):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, in_features))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias_hh = nn.Parameter(torch.zeros(4 * hidden))

    def reset_parameters_(self, generator):
        """flax's initialisers: lecun-normal input kernels, an orthogonal
        hidden kernel per gate, zero biases."""
        H = self.hidden
        with torch.no_grad():
            _lecun_(self.weight_ih, self.weight_ih.shape[1], generator)
            for g in range(4):
                nn.init.orthogonal_(self.weight_hh[g * H:(g + 1) * H],
                                    generator=generator)
            self.bias_hh.zero_()
        return self


def lstm(x, weight_ih, weight_hh, bias_hh):
    """Every step's hidden state ``[K, B, T, H]`` of the LSTM over ``x
    [K, B, T, in]`` with per-client ``weight_ih [K, 4H, in]``,
    ``weight_hh [K, 4H, H]``, ``bias_hh [K, 4H]``; the carry starts at 0."""
    K, B, T, n_in = x.shape
    H = weight_hh.shape[-1]
    xi = torch.bmm(x.reshape(K, B * T, n_in), weight_ih.transpose(1, 2))
    xi = (xi + bias_hh[:, None, :]).reshape(K, B, T, 4 * H)
    w_hh = weight_hh.transpose(1, 2)
    h = x.new_zeros(K, B, H)
    c = x.new_zeros(K, B, H)
    out = []
    for t in range(T):
        z = torch.baddbmm(xi[:, :, t], h, w_hh)
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    return torch.stack(out, dim=2)


class _RNNLM(nn.Module):
    """Shared functional application of the two LSTM LMs."""

    #: whether ``apply_params(with_sown=True)`` can return a nonzero aux
    sows_losses = False
    _embed_name = "embeddings"

    def reset_parameters_(self, generator):
        """flax's initialisers, drawn from ``generator``: embeddings
        normal with variance ``1/E``, dense kernels lecun-normal, zero
        biases, the LSTMs' own."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, LSTMLayer):
                    m.reset_parameters_(generator)
                elif isinstance(m, nn.Embedding):
                    nn.init.normal_(m.weight, 0.0,
                                    1.0 / math.sqrt(m.weight.shape[1]),
                                    generator=generator)
                elif isinstance(m, nn.Linear):
                    _lecun_(m.weight, m.weight.shape[1], generator)
                    m.bias.zero_()
        return self

    def _hidden(self, P, idx):
        """The last LSTM's states ``[K, B, T, H]`` of tokens ``[K, B, T]``."""
        x = embed(P[f"{self._embed_name}.weight"], idx, torch.float32)
        for name in self._lstm_names:
            x = lstm(x, P[f"{name}.weight_ih"], P[f"{name}.weight_hh"],
                     P[f"{name}.bias_hh"])
        return x

    def apply_params(self, params, idx, stacked=False, with_sown=False):
        """Logits of ``idx`` under ``params`` (``{name: tensor}``); with
        ``stacked=True`` every parameter has a leading client axis K and
        ``idx`` is ``[K, B, T]``. ``with_sown=True`` also returns the
        (zero) sown aux loss, per client."""
        if not stacked:
            params = {k: v.unsqueeze(0) for k, v in params.items()}
            idx = idx.unsqueeze(0)
        logits = self._head(params, self._hidden(params, idx))
        aux = torch.zeros(idx.shape[0], device=idx.device)
        if not stacked:
            logits, aux = logits[0], aux[0]
        return (logits, aux) if with_sown else logits

    def forward(self, idx, train=False):
        return self.apply_params(dict(self.named_parameters()), idx)


class RNNOriginalFedAvg(_RNNLM):
    """Embedding 8, two LSTMs of ``hidden_size``, the head over
    ``vocab_size`` (the reference's ``rnn`` and ``rnn_fed_shakespeare``)."""

    _lstm_names = ("lstm1", "lstm2")

    def __init__(self, embedding_dim=8, vocab_size=90, hidden_size=256,
                 output_all_timesteps=False):
        super().__init__()
        self.output_all_timesteps = output_all_timesteps
        self.embeddings = nn.Embedding(vocab_size, embedding_dim)
        self.lstm1 = LSTMLayer(embedding_dim, hidden_size)
        self.lstm2 = LSTMLayer(hidden_size, hidden_size)
        self.fc = nn.Linear(hidden_size, vocab_size)

    def _head(self, P, h):
        if not self.output_all_timesteps:
            h = h[:, :, -1]
        return dense(h, P["fc.weight"], P["fc.bias"], torch.float32)


class RNNStackOverflow(_RNNLM):
    """The StackOverflow next-word LSTM: extended vocabulary ``vocab_size
    + 3 + num_oov_buckets``, embedding ``embedding_size``,
    ``num_layers`` LSTMs of ``latent_size``, a projection back to
    ``embedding_size`` and the head."""

    _embed_name = "word_embeddings"

    def __init__(self, vocab_size=10000, num_oov_buckets=1,
                 embedding_size=96, latent_size=670, num_layers=1):
        super().__init__()
        self.extended_vocab = vocab_size + 3 + num_oov_buckets
        self.word_embeddings = nn.Embedding(self.extended_vocab,
                                            embedding_size)
        self._lstm_names = tuple(f"lstm{i + 1}" for i in range(num_layers))
        for i, name in enumerate(self._lstm_names):
            setattr(self, name, LSTMLayer(
                embedding_size if i == 0 else latent_size, latent_size))
        self.fc1 = nn.Linear(latent_size, embedding_size)
        self.fc2 = nn.Linear(embedding_size, self.extended_vocab)

    def _head(self, P, h):
        x = dense(h, P["fc1.weight"], P["fc1.bias"], torch.float32)
        return dense(x, P["fc2.weight"], P["fc2.bias"], torch.float32)


__all__ = ["LSTMLayer", "lstm", "RNNOriginalFedAvg", "RNNStackOverflow"]
