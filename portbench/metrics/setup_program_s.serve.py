"""setup_program_s.serve: seconds of set-up inside the program's set-up
spans (utils/profiling.setup_spans: build_model, create_train_state,
make_preprocess_fn, make_fused_infer_fn, FusedFeaturizer, load_library),
the length of their union on CLOCK_BOOTTIME, the clock of setup_s.  None
where the program keeps no such spans."""


def read(view):
    if view.kind != "serve":
        return None
    try:
        from audio_training_tpu_torch.utils.profiling import setup_spans
    except ImportError:
        return None
    from portbench.trace import union_length

    spans = setup_spans()
    return union_length((a, b) for _, a, b in spans) if spans else None
