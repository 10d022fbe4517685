from analytics_zoo_tpu_torch.models.seq2seq.seq2seq import Seq2Seq

__all__ = ["Seq2Seq"]
