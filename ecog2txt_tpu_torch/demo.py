"""Demo experiment factory: a complete synthetic experiment on disk.

Writes the two config files of the public API (the YAML manifest and
``block_breakdowns.json`` — reference README.md:32-57) plus vocab files
into a root directory, wired to :class:`SyntheticDataGenerator`.  This is
the framework's runnable quickstart and the fixture for end-to-end
tests (the reference has no public data generators).

The port's own copy of ``ecog2txt_tpu/demo.py`` (plain Python and numpy,
no JAX), with the same names and behaviour.
"""

from __future__ import annotations

import json
import os

import yaml

from .config import Manifest
from .datagen import SyntheticDataGenerator
from .tokenizers import write_vocab_file

def demo_blocks(
    num_training: int = 4, num_validation: int = 1, num_testing: int = 1
) -> dict[int, dict]:
    """Block-breakdown map (schema per reference README.md:37-39)."""
    out: dict[int, dict] = {}
    block = 1
    for partition, count in (
        ("training", num_training),
        ("validation", num_validation),
        ("testing", num_testing),
    ):
        for _ in range(count):
            out[block] = {
                "type": "demo",
                "default_dataset": partition,
                "audio": True,
                "bipolar": False,
            }
            block += 1
    return out


DEMO_BLOCKS = demo_blocks()


def make_demo_experiment(
    root: str,
    subject_ids: tuple[int, ...] = (1,),
    grid_size: tuple[int, int] = (4, 4),
    grid_sizes: dict | None = None,  # per-subject override (heterogeneous)
    num_unique_sentences: int = 10,
    num_sentences_per_block: int = 10,
    num_training_blocks: int = 4,
    N_epochs: int = 40,
    layer_sizes: dict | None = None,
    **manifest_overrides,
) -> str:
    """Create a synthetic experiment under ``root``; returns the manifest
    path.  Subject ``i`` gets blocks from :data:`DEMO_BLOCKS`."""
    root = os.path.abspath(root)
    os.makedirs(root, exist_ok=True)
    json_dir = root
    blocks = demo_blocks(num_training=num_training_blocks)

    with open(os.path.join(json_dir, "block_breakdowns.json"), "w") as f:
        json.dump({str(s): {str(b): d for b, d in blocks.items()}
                   for s in subject_ids}, f, indent=1)

    layer_sizes = layer_sizes or {
        # scaled-down mirror of the reference architecture
        # (mocha-1_word_sequence.yaml:56-69)
        "encoder_embedding": [32],
        "encoder_rnn": [64, 64],
        "encoder_1_projection": [32],
        "decoder_embedding": [24],
        "decoder_rnn": [96],
        "decoder_projection": [],
    }

    manifests = {}
    for subject_id in subject_ids:
        subject_manifest = {
            "DataGenerator": "SyntheticDataGenerator",
            "subject_name": f"demo{subject_id}",
            "project": "demo",
            "token_type": "word_sequence",
            "grid_size": list(
                (grid_sizes or {}).get(subject_id, grid_size)
            ),
            "grid_step": 1,
            "REFERENCE_BIPOLAR": False,
            "USE_FIELD_POTENTIALS": False,
            "sampling_rate": 200,
            "sampling_rate_decimated": 16.5,
            "decimation_factor": None,
            "num_mel_features": 26,
            "num_cepstral_coeffs": 13,
            "USE_LOG_MELS": False,
            "USE_MFCC_DELTAS": False,
            "mfcc_winlen": 0.02,
            "json_dir": json_dir,
            "tf_record_partial_path": os.path.join(
                root, "records", f"demo{subject_id}_B{{0}}.tfrecord"
            ),
            "checkpoint_dir": os.path.join(root, "checkpoints", str(subject_id)),
            "saved_results_dir": os.path.join(root, "results"),
            "block_types": {p: {"demo"} for p in ("training", "validation", "testing")},
            "block_descriptors": ["type"],
            "data_mapping": {
                "encoder_inputs": "ecog_sequence",
                "encoder_1_targets": "phoneme_sequence",
                "decoder_targets": "text_sequence",
            },
            "encoder_1_targets_penalty_scale": 1.0,
            "audio_sequence_penalty_scale": 0.1,
            "layer_sizes": layer_sizes,
            "num_unique_training_sentences": num_unique_sentences,
            "num_sentences_per_block": num_sentences_per_block,
            "N_epochs": N_epochs,
            "EMA_decay": 0.99,
            "FF_dropout": 0.1,
            "RNN_dropout": 0.5,
            "temperature": 0.384,
            "beam_width": 1,
            "assessment_epoch_interval": 10,
            "TEMPORALLY_CONVOLVE": True,
            "blocks": sorted(blocks),
        }
        subject_manifest.update(manifest_overrides)
        manifests[subject_id] = subject_manifest

    manifest_path = os.path.join(root, "demo_word_sequence.yaml")
    with open(manifest_path, "w") as f:
        yaml.safe_dump(manifests, f, default_flow_style=False)

    # vocab files induced from the deterministic sentence inventory
    gen = SyntheticDataGenerator(
        Manifest(manifests[subject_ids[0]], subject_ids[0]), subject_ids[0]
    )
    if manifests[subject_ids[0]]["token_type"] == "word_piece_sequence":
        from .tokenizers import SubwordEncoder

        encoder = SubwordEncoder.build_from_corpus(
            gen.sentences, target_vocab_size=128
        )
        write_vocab_file(
            os.path.join(root, "vocab.demo.words"), encoder.subwords
        )
    else:
        write_vocab_file(
            os.path.join(root, "vocab.demo.words"), gen.full_class_list()
        )
    write_vocab_file(
        os.path.join(root, "vocab.demo.phonemes"), gen.full_phoneme_list()
    )
    for subject_manifest in manifests.values():
        subject_manifest["text_sequence_vocab_file"] = os.path.join(
            root, "vocab.demo.words"
        )
        subject_manifest["phoneme_sequence_vocab_file"] = os.path.join(
            root, "vocab.demo.phonemes"
        )
    with open(manifest_path, "w") as f:
        yaml.safe_dump(manifests, f, default_flow_style=False)
    return manifest_path
