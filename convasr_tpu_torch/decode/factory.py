"""Decoder construction shared by the transcribe and train CLIs (counterpart
of convasr_tpu/decode/factory.py): --decoder, --decoder-topk, --lm and
--beam-* select the decoder that produces hypotheses.
"""
import torch

from . import beam
from ..ops import beam_device


class DeviceBeamDecoder:
    """BeamSearchDecoderDevice: the batched beam on the log-probs' device
    (ops/beam_device.py), with an optional char-bigram LM (--lm, a char-level
    ARPA densified by decode/beam.char_lm_table) fused there; only the best
    hypothesis's tokens come to the host."""

    topk = 1
    on_device = True

    def __init__(self, args, tokenizer, lm_table=None):
        self.args, self.tokenizer, self.lm_table = args, tokenizer, lm_table

    def decode(self, log_probs, output_lengths=None):
        args = self.args
        log_probs = torch.as_tensor(log_probs)
        tokens, lens, _ = beam_device.beam_search_device(
            log_probs, beam.frame_lengths(log_probs, output_lengths), self.tokenizer.eps_id,
            beam_width=args.beam_width, cutoff_top_n=args.beam_cutoff_top_n,
            max_len=int(log_probs.shape[1]) + 1, lm_table=self.lm_table,
            lm_alpha=args.beam_alpha, lm_beta=args.beam_beta)
        tokens, lens = tokens[:, 0].cpu().numpy(), lens[:, 0].cpu().numpy()
        return [tokens[b, :lens[b]].tolist() for b in range(len(tokens))]


class HybridBeamDecoder:
    """BeamSearchDecoderDeviceLM: the device beam's top-K complete
    hypotheses, rescored on the host with a word n-gram LM
    (decode/beam.decode_device_with_lm). K is --beam-width: keep it small
    (16)."""

    topk = 1
    on_device = True

    def __init__(self, args, tokenizer):
        self.args, self.tokenizer = args, tokenizer

    def decode(self, log_probs, output_lengths=None):
        args = self.args
        return beam.decode_device_with_lm(
            log_probs, output_lengths, self.tokenizer, lm_path=getattr(args, 'lm', None),
            alpha=args.beam_alpha, beta=args.beam_beta, beam_width=args.beam_width,
            cutoff_top_n=args.beam_cutoff_top_n,
            max_len=getattr(args, 'beam_max_len', None) or None)


def build_decoder(args, tokenizer, vocab=None, mesh=None):
    """None for GreedyDecoder (callers use the greedy CTC generator), else a
    decoder with .decode(log_probs, output_lengths=...) -> per-utterance
    token-id lists (top-1), or lists of top-k lists when args.decoder_topk > 1
    (host beam only), and .on_device: whether it takes the log-probs where
    they lie (the device beams) or as a host array (the C++ beam)."""
    if mesh is not None:
        raise NotImplementedError('a sharded device beam (--data-parallel) is not yet ported '
                                  'to convasr_tpu_torch')
    choice = getattr(args, 'decoder', 'GreedyDecoder')
    if choice in (None, '', 'GreedyDecoder'):
        return None
    if choice == 'BeamSearchDecoderDevice':
        lm_table = None
        if getattr(args, 'lm', None):
            lm_table = beam.char_lm_table(beam.load_lm(args.lm), vocab or tokenizer.vocab)
        return DeviceBeamDecoder(args, tokenizer, lm_table)
    if choice == 'BeamSearchDecoderDeviceLM':
        return HybridBeamDecoder(args, tokenizer)
    if choice == 'BeamSearchDecoder':
        return beam.BeamSearchDecoder(
            tokenizer, lm_path=getattr(args, 'lm', None),
            beam_width=args.beam_width, beam_alpha=args.beam_alpha,
            beam_beta=args.beam_beta,
            cutoff_top_n=getattr(args, 'beam_cutoff_top_n', None) or 40,
            topk=getattr(args, 'decoder_topk', 1),
            rescore=getattr(args, 'beam_rescore', False))
    raise ValueError(f'unknown decoder {choice!r}')
