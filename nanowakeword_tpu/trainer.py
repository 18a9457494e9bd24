"""Pipeline orchestrator: YAML config -> stages -> trained, exported model.

Parity target: `/root/reference/nanowakeword/trainer.py` — `train(cli_args)`
(`:124`): YAML load, smart directory verification with cached receipts
(`:224-269`), hardware auto-config merge (`:296-309`), stage sequencing
(-G generate / -t transform / -T train / -d distill), project directory
layout (`features/`, `training_artifacts/`, `model/`), dataset/sampler
construction (`:385-477`), export + journal (`:508-584`), and the standalone
distillation path (`:589-667`).

Accepts the reference's training_config.yaml schema unchanged.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import yaml

from nanowakeword_tpu.config.generator import ConfigGenerator
from nanowakeword_tpu.config.proxy import ConfigProxy, deep_merge
from nanowakeword_tpu.data.dataset import (AdaptiveLossAwareDataset,
                                           DynamicClassAwareSampler,
                                           ValidationDataset)
from nanowakeword_tpu.export.artifact import (EXTENSION, export_model,
                                              export_onnx_model,
                                              export_params_msgpack)
from nanowakeword_tpu.export.custom_export import (auto_gen_name,
                                                   export_custom_model)
from nanowakeword_tpu.models.model import Model
from nanowakeword_tpu.train.trainer import Trainer
from nanowakeword_tpu.utils.audio_io import verify_and_process_directory
from nanowakeword_tpu.utils.compile_cache import enable_compile_cache
from nanowakeword_tpu.utils.dynamic_table import DynamicTable
from nanowakeword_tpu.utils.journal import update_training_journal
from nanowakeword_tpu.utils.logger import (print_banner, print_error,
                                           print_info, print_step_header,
                                           print_warning)

SEED = 10


def _build_parser():
    parser = argparse.ArgumentParser(
        description="nanowakeword-tpu: wake word training "
                    "framework.",
        formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("-c", "--config_path", type=str, required=True,
                        metavar="PATH",
                        help="Path to the training configuration YAML file.")
    parser.add_argument("-G", "--generate_clips", action="store_true",
                        help="Synthesize audio clips from text (TTS).")
    parser.add_argument("-t", "--transform_clips", action="store_true",
                        help="Augment clips and extract features (.npy).")
    parser.add_argument("-T", "--train_model", action="store_true",
                        help="Train the wake word model.")
    parser.add_argument("-d", "--distill", action="store_true",
                        help="Distill a lite gate model (with -T or "
                             "standalone).")
    parser.add_argument("-f", "--force-verify", action="store_true",
                        help="Re-verify all data directories, ignoring the "
                             "cache.")
    parser.add_argument("--overwrite", action="store_true",
                        help="Overwrite existing feature files.")
    parser.add_argument("--resume", type=str, default=None, metavar="PATH",
                        help="Project directory to resume training from.")
    return parser


def _directory_state(path: str) -> dict:
    """File count + total bytes of audio files (trainer.py:206-222)."""
    audio_exts = {".wav", ".mp3", ".flac", ".m4a", ".ogg"}
    count, size = 0, 0
    try:
        for entry in os.scandir(path):
            if (entry.is_file()
                    and os.path.splitext(entry.name)[1].lower() in audio_exts):
                count += 1
                size += entry.stat().st_size
    except FileNotFoundError:
        pass
    return {"file_count": count, "total_size": size}


def smart_verify(path: str, cache_dir: str, force: bool = False):
    """Verify/convert a directory, skipping via cached state receipts
    (trainer.py:224-269)."""
    if not path:
        return
    receipt_path = os.path.join(
        cache_dir, hashlib.md5(path.encode("utf-8")).hexdigest() + ".json")

    if not force and os.path.exists(receipt_path):
        try:
            with open(receipt_path) as f:
                saved = json.load(f)
            if saved == _directory_state(path):
                print_info(f"'{os.path.basename(path)}' already verified. "
                           "Skipping.")
                return
            print_info(f"Data in '{os.path.basename(path)}' has changed. "
                       "Re-verifying...")
        except (json.JSONDecodeError, KeyError) as e:
            print_info(f"Could not parse receipt for "
                       f"'{os.path.basename(path)}'. Re-verifying... ({e})")

    try:
        verify_and_process_directory(path)
        with open(receipt_path, "w") as f:
            json.dump(_directory_state(path), f, indent=4)
    except FileNotFoundError:
        print_warning(f"Directory not found, skipping preprocessing: {path}")
    except Exception as e:  # noqa: BLE001
        print_warning(f"Unexpected error verifying "
                      f"'{os.path.basename(path)}': {e}")


def _build_training_data(config, manifest):
    dataset = AdaptiveLossAwareDataset(feature_manifests=manifest)
    if len(dataset) == 0:
        raise ValueError("CRITICAL: Dataset is empty. Check your feature "
                         "file paths in the manifest.")
    composition = config.get("batch_composition")
    if not composition:
        print_info("'batch_composition' not found in config. Using a default "
                   "balanced composition.")
        composition = {"targets": 30, "negatives": 230}
        print_info(f"Using default composition: {composition}")
    elif hasattr(composition, "to_dict"):
        composition = composition.to_dict()
    sampler = DynamicClassAwareSampler(dataset=dataset,
                                       batch_composition=composition,
                                       feature_manifests=manifest,
                                       seed=SEED)
    return dataset, sampler


def _train_end_to_end(config, e2e_cfg, args, model_name, project_dir,
                      artifacts_dir, model_save_dir, dynamic_table):
    """End-to-end (audio -> trained encoder + classifier) training stage.

    New capability vs. the reference (which can only train on precomputed
    features of a frozen encoder). Config:

        end_to_end:
          enabled: true
          audio_manifest:              # categories -> dirs (or {key: dir})
            targets: [data/positive]
            negatives: [data/negative]
          clip_samples: 32000
          context_frames: 16
          freeze_encoder: false
    """
    from nanowakeword_tpu.data.dataset import DynamicClassAwareSampler
    from nanowakeword_tpu.train.e2e import AudioClipDataset, E2EModel

    audio_manifest = e2e_cfg.get("audio_manifest")
    if hasattr(audio_manifest, "to_dict"):
        audio_manifest = audio_manifest.to_dict()
    if not audio_manifest:
        audio_manifest = {
            "targets": [config.get("positive_data_path")],
            "negatives": [config.get("negative_data_path")],
        }

    clip_samples = int(e2e_cfg.get("clip_samples",
                                   config.get("clip_length_samples", 32000)))
    context_frames = int(e2e_cfg.get("context_frames", 16))

    dataset = AudioClipDataset(audio_manifest, clip_samples=clip_samples)
    if len(dataset) == 0:
        raise ValueError("CRITICAL: end_to_end.audio_manifest matched no "
                         ".wav files.")

    composition = config.get("batch_composition")
    if hasattr(composition, "to_dict"):
        composition = composition.to_dict()
    if not composition:
        composition = {"targets": 8, "negatives": 16}
    sampler = DynamicClassAwareSampler(
        dataset=dataset, batch_composition=composition,
        feature_manifests={c: (d if isinstance(d, dict)
                               else {f"{c}_{i}": p
                                     for i, p in enumerate(d)})
                           for c, d in audio_manifest.items()},
        seed=SEED)

    print_info("Initializing end-to-end acoustic stack "
               f"(clip={clip_samples} samples, context={context_frames} "
               "frames)...")
    classifier = Model(
        n_classes=1, input_shape=(context_frames, 96), config=config,
        model_name=model_name, model_type=config.get("model_type", "dnn"),
        layer_dim=int(config["layer_size"]),
        n_blocks=int(config["n_blocks"]),
        dropout_prob=float(config.get("dropout_prob", 0.5)))
    e2e = E2EModel(classifier, clip_samples=clip_samples,
                   context_frames=context_frames,
                   freeze_encoder=bool(e2e_cfg.get("freeze_encoder", False)))
    print_info(f"End-to-end parameters: {e2e.n_params():,} "
               "(encoder + classifier)")

    trainer_instance = Trainer(model=e2e, config=config)
    print_step_header("End-to-end training in progress")
    trainer_instance.auto_train(
        X_train=(dataset, sampler), X_val=None,
        steps=int(config.get("steps", 15000)),
        debug_path=artifacts_dir, table_updater=dynamic_table,
        resume_from_dir=args.resume)

    classifier.plot_history(artifacts_dir)
    trained_classifier, encoder_vars = e2e.export_components()
    export_model(trained_classifier, (context_frames, 96), config,
                 model_name, model_save_dir, encoder_variables=encoder_vars)
    export_params_msgpack(trained_classifier, model_name, model_save_dir)
    try:
        from nanowakeword_tpu.export.frontend import export_frontend_onnx
        export_frontend_onnx(encoder_vars, clip_samples, model_name,
                             model_save_dir)
        print_info("Feature-frontend ONNX graphs (trained encoder) "
                   "exported.")
    except Exception as e:  # noqa: BLE001
        print_warning(f"Frontend ONNX export failed (non-fatal): {e}")
    try:
        export_custom_model(trained_classifier, (context_frames, 96), config,
                            model_name, model_save_dir)
    except Exception as e:  # noqa: BLE001
        print_warning(f"Custom export hook encountered an error: {e}")
    print_info(f"End-to-end model (with trained encoder) exported to "
               f"{model_save_dir}")


def _check_weights_dtype(dist_cfg) -> None:
    """Reject a bad distillation.weights_dtype before any training runs."""
    from nanowakeword_tpu.export.artifact import WEIGHTS_DTYPES
    wd = dist_cfg.get("weights_dtype")
    if wd is not None and wd not in WEIGHTS_DTYPES:
        raise ValueError("distillation.weights_dtype must be one of "
                         f"{WEIGHTS_DTYPES}, got {wd!r}")


def train(cli_args=None):
    args = _build_parser().parse_args(cli_args)
    print_banner()
    enable_compile_cache()

    with open(args.config_path, "r", encoding="utf-8") as f:
        user_config = yaml.load(f.read(), yaml.Loader)

    output_dir_from_config = user_config.get("output_dir", "./trained_models")
    cache_dir = os.path.join(output_dir_from_config, ".cache",
                             "verification_receipts")
    os.makedirs(cache_dir, exist_ok=True)

    # -- audio directory verification (opt-in) -------------------------------
    if user_config.get("convert_audio", False) is True:
        print_step_header("Verifying and Preprocessing Data Directories")
        paths = [user_config.get("positive_data_path"),
                 user_config.get("negative_data_path")]
        paths.extend(user_config.get("background_paths", []) or [])
        paths.extend(user_config.get("rir_paths", []) or [])
        force = args.force_verify or user_config.get("force_verify", False)
        if force:
            print_info("User has forced re-verification of all data "
                       "directories.")
        for path in set(p for p in paths if p):
            smart_verify(path, cache_dir, force=force)
        print_info("Data verification and preprocessing complete.\n")

    # -- hardware auto-config -------------------------------------------------
    print_info("Determining hardware-specific configurations...")
    try:
        hardware_config = ConfigGenerator().generate()
        base_config = dict(hardware_config)
        base_config.update(user_config)
    except Exception as e:  # noqa: BLE001
        print_info(f"Could not generate hardware config: {e}. Proceeding "
                   "with user config only.")
        base_config = dict(user_config)

    # -- stage: generate clips -------------------------------------------------
    if args.generate_clips or base_config.get("generate_clips", False):
        from nanowakeword_tpu.data.generator.generate_clips import \
            generate_clips
        generate_clips(base_config)

    final_config = deep_merge(base_config, user_config)
    config = ConfigProxy(final_config)

    dynamic_table = DynamicTable(
        config, title="Effective Training Configuration",
        enabled=bool(config.get("show_training_summary", True)))

    model_name = config.get(
        "model_name", auto_gen_name(config.get("model_type", "dnn"),
                                    base_dir=output_dir_from_config
                                    if os.path.isdir(output_dir_from_config)
                                    else "."))
    project_dir = os.path.join(os.path.abspath(base_config["output_dir"]),
                               model_name)
    feature_save_dir = os.path.join(project_dir, "features")
    artifacts_dir = os.path.join(project_dir, "training_artifacts")
    model_save_dir = os.path.join(project_dir, "model")
    for path in (project_dir, feature_save_dir, artifacts_dir, model_save_dir):
        os.makedirs(path, exist_ok=True)
    print_info(f"Project assets will be saved in: {project_dir}")

    # -- stage: transform (feature generation) -----------------------------------
    if args.transform_clips or config.get("transform_clips", False):
        from nanowakeword_tpu.data.transform_clips import transform_clips
        transform_clips(config=config, args=args,
                        feature_save_dir=feature_save_dir)

    # -- stage: training -----------------------------------------------------------
    should_train = args.train_model or config.get("train_model", False)
    e2e_cfg = config.get("end_to_end", {})
    e2e_enabled = bool(e2e_cfg.get("enabled", False)) if e2e_cfg else False

    if should_train and e2e_enabled:
        _train_end_to_end(config, e2e_cfg, args, model_name, project_dir,
                          artifacts_dir, model_save_dir, dynamic_table)
    elif should_train:
        training_start = time.time()

        full_manifest = config.get("feature_manifest", {})
        if hasattr(full_manifest, "to_dict"):
            full_manifest = full_manifest.to_dict()
        manifest = {cat: paths for cat, paths in full_manifest.items()
                    if not cat.endswith("_val")}
        dataset, sampler = _build_training_data(config, manifest)

        print_info("Checking for validation data...")
        val_manifest = {cat.replace("_val", ""): paths
                        for cat, paths in full_manifest.items()
                        if cat.endswith("_val")}
        val_dataset = None
        if val_manifest:
            try:
                vd = ValidationDataset(feature_manifest=val_manifest)
                if len(vd) > 0:
                    val_dataset = vd
                    print_info(f"Validation dataset: {len(vd)} samples.")
                else:
                    print_info("Validation manifest found but empty. "
                               "Skipping validation.")
            except Exception as e:  # noqa: BLE001
                print_error(f"Failed to create validation dataset: {e}")
        else:
            print_info("No validation keys (e.g. 'targets_val') in "
                       "feature_manifest. Skipping validation.")

        sample_feature, _, _ = dataset[0]
        input_shape = sample_feature.shape
        seconds_per_example = (1280 * input_shape[0]) / 16000
        print_info(f"Input Shape Detected: {input_shape} "
                   f"({seconds_per_example:.2f}s context)")

        print_info("Initializing Neural Architecture...")
        nww = Model(
            n_classes=1, input_shape=input_shape, config=config,
            model_name=model_name,
            model_type=config.get("model_type", "dnn"),
            layer_dim=int(config["layer_size"]),
            n_blocks=int(config["n_blocks"]),
            dropout_prob=float(config.get("dropout_prob", 0.5)),
            seconds_per_example=seconds_per_example)

        trainer_instance = Trainer(model=nww, config=config)

        print_step_header("Training in progress")
        best_model = trainer_instance.auto_train(
            X_train=(dataset, sampler), X_val=val_dataset,
            steps=int(config.get("steps", 15000)),
            debug_path=artifacts_dir, table_updater=dynamic_table,
            resume_from_dir=args.resume)

        nww.plot_history(artifacts_dir)
        training_minutes = (time.time() - training_start) / 60

        from nanowakeword_tpu.data.features import default_encoder_variables
        encoder_vars = default_encoder_variables()
        export_model(best_model, input_shape, config, model_name,
                     model_save_dir, encoder_variables=encoder_vars)
        from nanowakeword_tpu.export.onnx_export import SUPPORTED_TYPES
        if best_model.model_type in SUPPORTED_TYPES:
            try:
                export_onnx_model(best_model, input_shape, config,
                                  model_name, model_save_dir)
            except Exception as e:  # noqa: BLE001
                print_warning(f"ONNX export failed (non-fatal): {e}")

        # feature frontend beside every export: raw audio -> [B, T, 96] +
        # the streaming mel/embedding pair, so the exported classifier
        # deploys end-to-end without JAX (the reference's onnxruntime-only
        # edge mode; its mel/embedding stages ARE onnx models,
        # interpreter/models/_registry.py:34-47)
        try:
            from nanowakeword_tpu.export.frontend import export_frontend_onnx
            clip_samples = int(config.get(
                "total_length",
                ((input_shape[0] - 1) * 8 + 76 + 4) * 160))
            export_frontend_onnx(encoder_vars, clip_samples, model_name,
                                 model_save_dir)
            print_info("Feature-frontend ONNX graphs exported "
                       "(_frontend / _mel_stream / _embedding).")
        except Exception as e:  # noqa: BLE001
            print_warning(f"Frontend ONNX export failed (non-fatal): {e}")

        dist_cfg = config.get("distillation", {})
        should_distill = bool(dist_cfg.get("enabled", True)) or args.distill
        if should_distill:
            try:
                _check_weights_dtype(dist_cfg)  # fail BEFORE the 8k steps
                print_step_header("Distillation: Building Lite Model")
                from nanowakeword_tpu.train.distill import distill_model
                student = distill_model(teacher=best_model,
                                        X_train=(dataset, sampler),
                                        config=config,
                                        input_shape=input_shape)
                export_model(student, input_shape, config,
                             model_name + "_lite", model_save_dir,
                             encoder_variables=encoder_vars,
                             weights_dtype=dist_cfg.get("weights_dtype"))
                try:
                    export_onnx_model(student, input_shape, config,
                                      model_name + "_lite", model_save_dir,
                                      weights_dtype=dist_cfg.get(
                                          "weights_dtype"))
                except Exception as e:  # noqa: BLE001
                    print_warning(f"ONNX export of lite model failed: {e}")
                try:
                    export_custom_model(student, input_shape, config,
                                        model_name + "_lite", model_save_dir)
                except Exception as e:  # noqa: BLE001
                    print_warning(f"Custom export hook for lite model "
                                  f"failed: {e}")
                print_info(f"Lite model saved alongside main model in: "
                           f"{model_save_dir}")
            except Exception as e:  # noqa: BLE001
                print_error(f"Distillation failed and was skipped. "
                            f"Details: {e}")

        export_params_msgpack(best_model, model_name, model_save_dir)
        try:
            export_custom_model(best_model, input_shape, config, model_name,
                                model_save_dir)
        except Exception as e:  # noqa: BLE001
            print_warning(f"Custom export hook encountered an error: {e}")

        if config.get("enable_journaling", True):
            final_metrics = {}
            report = nww.history.get("final_report") or {}
            final_metrics["Stable Loss"] = report.get("Average Stable Loss",
                                                      "N/A")
            final_metrics["Avg. Pos Conf"] = report.get(
                "Avg. Positive Score (Logit)", "N/A")
            final_metrics["Avg. Neg Conf"] = report.get(
                "Avg. Negative Score (Logit)", "N/A")
            final_metrics["Train Time"] = f"{training_minutes:.1f}"
            update_training_journal(
                base_output_dir=os.path.abspath(base_config["output_dir"]),
                model_name=model_name, metrics=final_metrics,
                current_config=config.report())

    # -- standalone distillation (trainer.py:589-667) --------------------------------
    elif args.distill and not should_train:
        print_step_header("Standalone Distillation: Building Lite Model from "
                          "Existing Artifact")
        artifact_path = os.path.join(model_save_dir, model_name + EXTENSION)
        if not os.path.exists(artifact_path):
            print_error(f"No trained model artifact found at "
                        f"'{artifact_path}'.\nTrain the model first with -T, "
                        "then run --distill standalone.")
            sys.exit(1)

        full_manifest = config.get("feature_manifest", {})
        if hasattr(full_manifest, "to_dict"):
            full_manifest = full_manifest.to_dict()
        manifest = {cat: paths for cat, paths in full_manifest.items()
                    if not cat.endswith("_val")}
        if not manifest:
            print_error("No feature_manifest entries found in config. Cannot "
                        "run standalone distillation.")
            sys.exit(1)
        dataset, sampler = _build_training_data(config, manifest)
        sample_feature, _, _ = dataset[0]

        try:
            from nanowakeword_tpu.train.distill import distill_from_artifact
            distill_from_artifact(
                artifact_path=artifact_path, X_train=(dataset, sampler),
                config=config, input_shape=sample_feature.shape,
                output_dir=model_save_dir, model_name=model_name)
        except Exception as e:  # noqa: BLE001
            print_error(f"Standalone distillation failed. Details: {e}")
            sys.exit(1)


if __name__ == "__main__":
    train()
