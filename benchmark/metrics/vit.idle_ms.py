"""Idle ms an iteration in the ViT policy's trunk: the measured idle of an
iteration apportioned to the traced gaps under ``parc.vit.tokenize`` (the
conv tokenizer and the segment tokens) and ``parc.vit.encode`` (the
encoder layers), in the rollout's acts, the targets' critic passes and the
update's forward passes, harness/spans. None where the program opens no
such span."""

from harness import spans


def read(run):
    return spans.idle_ms(run, ("parc.vit.tokenize", "parc.vit.encode"))
