"""KNRM — kernel-pooling neural ranking model for text matching.

Counterpart of ``analytics_zoo_tpu/models/textmatching/knrm.py`` (ref
``pyzoo/zoo/models/textmatching/knrm.py`` and Scala ``KNRM.scala``):
query and document ids (one ``Narrow`` each) → one shared embedding
table → the cosine translation matrix → RBF kernel pooling
(``kernel_num`` gaussians, the first an exact-match kernel at mu = 1) →
log soft-TF features → a dense score. The two ``Lambda`` functions are
torch functions with the JAX package's arithmetic order: each norm plus
1e-8, one batched ``einsum("bqe,bde->bqd")``, ``exp(-(s - mu)^2 / (2
sigma^2))``, the sum over the document, ``log1p(max(., 0))``, the sum
over the query. ``evaluate_ndcg`` and ``evaluate_map`` score one query's
candidate list on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from analytics_zoo_tpu_torch.keras import Input, Model
from analytics_zoo_tpu_torch.keras import layers as zl
from analytics_zoo_tpu_torch.models.common import ZooModel, registry


def cosine_sim(qe: torch.Tensor, de: torch.Tensor) -> torch.Tensor:
    """``[b, q, e]`` and ``[b, d, e]`` → the ``[b, q, d]`` cosines
    (``jnp.linalg.norm``'s square root of the summed squares)."""
    qn = qe / (torch.sqrt(torch.sum(qe * qe, dim=-1, keepdim=True)) + 1e-8)
    dn = de / (torch.sqrt(torch.sum(de * de, dim=-1, keepdim=True)) + 1e-8)
    return torch.einsum("bqe,bde->bqd", qn, dn)


def kernel_mu_sigma(kernel_num: int, sigma: float, exact_sigma: float):
    """The kernels' centres and widths (ref knrm.py:101-120): mu_k = 1 -
    2k / (K - 1), the first an exact-match kernel at 1 of width
    ``exact_sigma``."""
    k = np.arange(kernel_num, dtype=np.float32)
    mu = 1.0 - 2.0 * k / (kernel_num - 1.0)
    mu[0] = 1.0
    sig = np.full(kernel_num, sigma, np.float32)
    sig[0] = exact_sigma
    return mu, sig


@registry.register
class KNRM(ZooModel):
    """(ref knrm.py KNRM(text1_length, text2_length, embedding_file,
    word_index, train_embed, kernel_num=21, sigma=0.1, exact_sigma=0.001,
    target_mode="ranking"))"""

    def __init__(self, text1_length: int, text2_length: int,
                 vocab_size: int, embed_dim: int = 50,
                 kernel_num: int = 21, sigma: float = 0.1,
                 exact_sigma: float = 0.001, target_mode: str = "ranking"):
        super().__init__()
        if kernel_num < 2:
            raise ValueError("kernel_num must be >= 2")
        if target_mode not in ("ranking", "classification"):
            raise ValueError(f"target_mode must be ranking|classification, "
                             f"got {target_mode!r}")
        self.text1_length = int(text1_length)
        self.text2_length = int(text2_length)
        self.vocab_size = int(vocab_size)
        self.embed_dim = int(embed_dim)
        self.kernel_num = int(kernel_num)
        self.sigma = float(sigma)
        self.exact_sigma = float(exact_sigma)
        self.target_mode = target_mode
        self.model = self.build_model()

    def _kernel_pool(self, sim: torch.Tensor) -> torch.Tensor:
        """``[b, t1, t2]`` cosines → ``[b, kernel_num]`` soft-TF."""
        mu, sig = kernel_mu_sigma(self.kernel_num, self.sigma,
                                  self.exact_sigma)
        mu_b = torch.from_numpy(mu).to(sim.device)
        sig_b = torch.from_numpy(sig).to(sim.device)
        g = torch.exp(-((sim[..., None] - mu_b) ** 2) / (2.0 * sig_b ** 2))
        soft_tf = torch.sum(g, dim=2)                    # [b, t1, K]
        log_tf = torch.log1p(torch.clamp(soft_tf, min=0.0))
        return torch.sum(log_tf, dim=1)                  # [b, K]

    def build_model(self):
        inp = Input(shape=(self.text1_length + self.text2_length,))
        q_ids = zl.Narrow(1, 0, self.text1_length)(inp)
        d_ids = zl.Narrow(1, self.text1_length, self.text2_length)(inp)
        embed = zl.Embedding(self.vocab_size + 1, self.embed_dim,
                             name="word_embedding")
        q = embed(q_ids)                                 # shared table
        d = embed(d_ids)
        sim = zl.Lambda(cosine_sim)([q, d])
        feats = zl.Lambda(self._kernel_pool)(sim)
        if self.target_mode == "ranking":
            out = zl.Dense(1, activation="sigmoid")(feats)
        else:
            out = zl.Dense(2, activation="softmax")(feats)
        return Model(input=inp, output=out)

    def _config(self):
        return dict(text1_length=self.text1_length,
                    text2_length=self.text2_length,
                    vocab_size=self.vocab_size, embed_dim=self.embed_dim,
                    kernel_num=self.kernel_num, sigma=self.sigma,
                    exact_sigma=self.exact_sigma,
                    target_mode=self.target_mode)


def evaluate_ndcg(y_true, y_score, k: int = 10) -> float:
    """NDCG@k over one query's candidate list (ref Scala
    models/textmatching ranking metrics surfaced via KNRM.evaluateNDCG)."""
    y_true = np.asarray(y_true, np.float64).reshape(-1)
    y_score = np.asarray(y_score, np.float64).reshape(-1)
    order = np.argsort(-y_score)[:k]
    gains = (2.0 ** y_true[order] - 1) / np.log2(np.arange(2, len(order) + 2))
    ideal_order = np.argsort(-y_true)[:k]
    ideal = (2.0 ** y_true[ideal_order] - 1) / np.log2(
        np.arange(2, len(ideal_order) + 2))
    denom = ideal.sum()
    return float(gains.sum() / denom) if denom > 0 else 0.0


def evaluate_map(y_true, y_score) -> float:
    """Average precision for one query (ref KNRM.evaluateMAP)."""
    y_true = np.asarray(y_true, np.float64).reshape(-1)
    y_score = np.asarray(y_score, np.float64).reshape(-1)
    order = np.argsort(-y_score)
    rel = (y_true[order] > 0).astype(np.float64)
    if rel.sum() == 0:
        return 0.0
    precision_at = np.cumsum(rel) / np.arange(1, len(rel) + 1)
    return float((precision_at * rel).sum() / rel.sum())
