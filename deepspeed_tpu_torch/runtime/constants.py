"""Config key names (port of the training subset of
``deepspeed_tpu/runtime/constants.py``; ref: ``deepspeed/runtime/constants.py``)."""

TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

OPTIMIZER = "optimizer"
SCHEDULER = "scheduler"
ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
FUSED_ADAM_OPTIMIZER = "fusedadam"
CPU_ADAM_OPTIMIZER = "cpuadam"
LAMB_OPTIMIZER = "lamb"
FUSED_LAMB_OPTIMIZER = "fusedlamb"
LION_OPTIMIZER = "lion"
ADAGRAD_OPTIMIZER = "adagrad"
SGD_OPTIMIZER = "sgd"
ONEBIT_OPTIMIZERS = ("onebitadam", "zerooneadam", "onebitlamb")

FP16 = "fp16"
BFLOAT16 = "bf16"
BFLOAT16_OLD = "bfloat16"

GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0
GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
GRADIENT_PREDIVIDE_FACTOR_DEFAULT = 1.0
STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = None
WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False

ZERO_OPTIMIZATION = "zero_optimization"
ZERO_QUANTIZED_GRADIENTS = "zero_quantized_gradients"
ZEROPP_LOCO_PARAM = "zeropp_loco_param"
ZEROPP_LOCO_ERR_BETA_DEFAULT = 0.8

SPARSE_ATTENTION = "sparse_attention"

TENSOR_PARALLEL = "tensor_parallel"
SEQUENCE_PARALLEL_SIZE = "sequence_parallel_size"
PIPELINE = "pipeline"
MOE = "moe"
COMPRESSION_TRAINING = "compression_training"
PROGRESSIVE_LAYER_DROP = "progressive_layer_drop"

CHECKPOINT = "checkpoint"
CHECKPOINT_TAG_VALIDATION_MODES = ["Warn", "Ignore", "Fail"]
NEBULA = "nebula"
TENSORBOARD = "tensorboard"
WANDB = "wandb"
CSV_MONITOR = "csv_monitor"
COMET = "comet"

ACTIVATION_CHECKPOINTING = "activation_checkpointing"
FLOPS_PROFILER = "flops_profiler"
COMMS_LOGGER = "comms_logger"
HYBRID_ENGINE = "hybrid_engine"
EIGENVALUE = "eigenvalue"
ELASTICITY = "elasticity"
DATA_EFFICIENCY = "data_efficiency"
