"""The flagship configuration, its K = 120 and K = 148 variants and the
small synthetic config, built in code.

The same mappings as ``cfgs/dare_qnn_next_tpu.yaml``,
``cfgs/v3_k120_s1_tpu.yaml`` and ``cfgs/v3_k148_s1_tpu.yaml`` resolved
over their bases, and ``cfgs/synth_small.yaml`` (tests hold them equal),
so ``chip_smoke.py`` builds their ``Config``s with ``Config.from_dict`` on
a machine without PyYAML.
"""

import copy

_FLAGSHIP = {'exp_name': 'dare_qnn_next_tpu',
 'seed': 777,
 'deterministic': True,
 'amp': 'bf16',
 'data': {'train_path': './data/train.parquet',
          'test_path': './data/test.parquet',
          'cache_dir': './cache/dare_qnn_tpu',
          'shard_rows': 2000000,
          'add_isna_mask': True,
          'impute_strategy': 'median',
          'cat_cols': ['gender',
                       'age_group',
                       'inventory_id',
                       'day_of_week',
                       'hour',
                       'l_feat_1',
                       'l_feat_2',
                       'l_feat_3',
                       'l_feat_4',
                       'l_feat_5',
                       'l_feat_6',
                       'l_feat_7',
                       'l_feat_8',
                       'l_feat_9',
                       'l_feat_10',
                       'l_feat_11',
                       'l_feat_12',
                       'l_feat_13',
                       'l_feat_14',
                       'l_feat_15',
                       'l_feat_16',
                       'l_feat_17',
                       'l_feat_18',
                       'l_feat_19',
                       'l_feat_20',
                       'l_feat_21',
                       'l_feat_22',
                       'l_feat_23',
                       'l_feat_24',
                       'l_feat_25',
                       'l_feat_26',
                       'l_feat_27',
                       'feat_a_2',
                       'feat_a_8',
                       'feat_a_9'],
          'default_hash_bucket': 1009,
          'hash_buckets': {'inventory_id': 1020,
                           'hour': 1026,
                           'l_feat_4': 1028,
                           'l_feat_5': 2078,
                           'l_feat_6': 1902,
                           'l_feat_7': 1315,
                           'l_feat_9': 1478,
                           'l_feat_10': 1264,
                           'l_feat_11': 2526,
                           'l_feat_12': 6052,
                           'l_feat_14': 4239,
                           'l_feat_15': 3584,
                           'l_feat_17': 1478,
                           'l_feat_25': 2790,
                           'l_feat_26': 1020},
          'num_patterns': ['feat_*', 'history_*', 'l_feat_*']},
 'sequence': {'col': 'seq',
              'max_len': 400,
              'pad_id': 0,
              'top_k': 60,
              'recency_tau': 512,
              'query_mode': 'concat',
              'query_key': 'inventory_id',
              'transformer_block': True,
              'tfm': {'n_layers': 3,
                      'n_heads': 8,
                      'mha_dropout': 0.1,
                      'ffn_hidden': 384,
                      'ffn_dropout': 0.1,
                      'norm': 'rms',
                      'gating': 'softmax',
                      'add_positional_bias': True}},
 'model': {'emb_dim': 64,
           'seq_vocab': 10000000,
           'table_dtype': 'bfloat16',
           'use_pallas_attention': True,
           'dare_dropout': 0.2,
           'cat_embedding_dims': {'gender': 8,
                                  'age_group': 8,
                                  'day_of_week': 8,
                                  'hour': 8,
                                  'inventory_id': 16,
                                  'l_feat_1': 8,
                                  'l_feat_2': 8,
                                  'l_feat_3': 8,
                                  'l_feat_4': 8,
                                  'l_feat_5': 33,
                                  'l_feat_6': 30,
                                  'l_feat_7': 18,
                                  'l_feat_8': 8,
                                  'l_feat_9': 22,
                                  'l_feat_10': 17,
                                  'l_feat_11': 40,
                                  'l_feat_12': 64,
                                  'l_feat_13': 8,
                                  'l_feat_14': 57,
                                  'l_feat_15': 51,
                                  'l_feat_16': 8,
                                  'l_feat_17': 22,
                                  'l_feat_18': 8,
                                  'l_feat_19': 8,
                                  'l_feat_20': 8,
                                  'l_feat_21': 8,
                                  'l_feat_22': 8,
                                  'l_feat_23': 8,
                                  'l_feat_24': 8,
                                  'l_feat_25': 43,
                                  'l_feat_26': 8,
                                  'l_feat_27': 8,
                                  'feat_a_2': 8,
                                  'feat_a_8': 8,
                                  'feat_a_9': 8},
           'qnn_alpha': {'enabled': True,
                         'feature_embed_dim': 32,
                         'heads': 6,
                         'rank': 16,
                         'proj_dim': 192,
                         'mlp_hidden': [512, 256],
                         'dropout': 0.2,
                         'use_se': True,
                         'se_reduction': 8,
                         'use_residual': True,
                         'norm': 'rms',
                         'pair_grouping': 'all',
                         'aux_head_weight': 0.1}},
 'train': {'batch_size': 8192,
           'epochs': 8,
           'lr': 0.0003,
           'weight_decay': 0.0001,
           'warmup_epochs': 2,
           'cosine': True,
           'early_stop_patience': 3,
           'grad_clip_norm': 0.5,
           'embedding_optimizer': 'rowwise_adagrad',
           'exact_dedup': True,
           'rng_impl': 'rbg',
           'step_checkpointing': True},
 'cv': {'n_splits': 5,
        'group_key': 'inventory_id',
        'stratify_target': 'clicked',
        'time_key': 'day_of_week',
        'composite_group': True},
 'eval': {'score_formula': 'reference'},
 'calibration': {'enabled': True, 'method': 'temperature'},
 'logging': {'log_dir': './runs', 'tb': True, 'csv_log': True},
 'ensemble': {'method': 'logit_mean',
              'trim_ratio': 0.2,
              'val_weight_temperature': 10.0},
 'ema': {'enabled': True, 'decay': 0.999, 'eval_with_ema': True},
 'mesh': {'data': -1, 'model': 1}}


def flagship_config_dict() -> dict:
    """A fresh copy of the flagship config mapping."""
    return copy.deepcopy(_FLAGSHIP)


# cfgs/v3_k120_s1_tpu.yaml without its ``base:`` (the flagship): K = 120,
# S1 query, 4 encoder layers, heavier dropout, EMA off
_V3_K120 = {
    'exp_name': 'v3_k120_s1_tpu',
    'data': {'cache_dir': './cache/v3_k120_tpu', 'hash_buckets_margin': 500},
    'sequence': {'top_k': 120, 'query_mode': 'S1',
                 'tfm': {'n_layers': 4, 'ffn_dropout': 0.15}},
    'model': {'dare_dropout': 0.25, 'cat_embedding_dims': {'inventory_id': 32}},
    'train': {'monitor': 'score'},
    'sampler': {'type': None, 'pos_fraction': 0.5},
    'ema': {'enabled': False, 'warmup_type': 'linear', 'warmup_steps': 3000,
            'update_after_step': 0, 'update_interval': 1, 'ema_on_buffers': 'copy'},
    'ensemble': {'val_weight_temperature': 5.0},
    'features': {'covis': {
        'enabled': False, 'work_dir': './cache/covis',
        'target_keys': ['inventory_id', 'l_feat_14'], 'use_time_bin': True,
        'time_bin': 'day_of_week', 'seq_top_k': 120, 'recency_tau': 512,
        'prior_strength': 50, 'min_impr': 10, 'ctr_clip': [0.001, 0.999],
        'backoff': ['pair', 'token', 'target', 'global'],
        'agg': {'topn': 3, 'outputs': ['sum_ctr', 'mean_ctr', 'max_ctr', 'top3_mean_ctr',
                                       'wmean_ctr', 'sum_impr', 'max_impr', 'pnorm_ctr']}}},
}


def v3_k120_config_dict() -> dict:
    """A fresh copy of ``cfgs/v3_k120_s1_tpu.yaml`` resolved over its base,
    the flagship, as ``schema.load_yaml_with_base`` resolves it."""
    from .schema import deep_merge

    return deep_merge(flagship_config_dict(), copy.deepcopy(_V3_K120))


# cfgs/v3_k148_s1_tpu.yaml without its ``base:`` (v3_k120_s1_tpu): K = 148,
# B = 4096, covis features on (the port's model reads none of them), the
# optional loss block at zero weights
_V3_K148 = {
    'exp_name': 'v3_k148_s1_tpu',
    'data': {'cache_dir': './cache/v3_k148_tpu'},
    'sequence': {'top_k': 148},
    'train': {'batch_size': 4096},
    'loss': {'lambda_rank': 0.0, 'lambda_logit_l2': 0.0, 'num_neg_per_pos': 0,
             'hard_neg_frac': 0.0},
    'features': {'covis': {'enabled': True}},
}


def v3_k148_config_dict() -> dict:
    """A fresh copy of ``cfgs/v3_k148_s1_tpu.yaml`` resolved over its base
    (``v3_k120_config_dict``), as ``schema.load_yaml_with_base`` resolves
    it."""
    from .schema import deep_merge

    return deep_merge(v3_k120_config_dict(), copy.deepcopy(_V3_K148))


# cfgs/synth_small.yaml: the full stack at toy sizes (D = 32, 2 layers of
# 4 heads, K = 12, a 6000-row table), fp32, and the schema's default
# dense-mode table optimizer, AdamW
_SYNTH_SMALL = {
    'exp_name': 'synth_small', 'seed': 777, 'device': 'tpu', 'deterministic': True,
    'amp': 'none',
    'data': {'train_path': '/tmp/tossctr_synth/train.parquet',
             'test_path': '/tmp/tossctr_synth/test.parquet',
             'cache_dir': '/tmp/tossctr_synth/cache', 'shard_rows': 8000,
             'add_isna_mask': True, 'impute_strategy': 'median',
             'cat_cols': ['gender', 'age_group', 'inventory_id', 'day_of_week', 'hour',
                          'l_feat_1', 'l_feat_2'],
             'hash_buckets': {'gender': 101, 'age_group': 101, 'inventory_id': 503,
                              'day_of_week': 101, 'hour': 101, 'l_feat_1': 101,
                              'l_feat_2': 101},
             'num_patterns': ['feat_*', 'history_*']},
    'sequence': {'col': 'seq', 'max_len': 48, 'pad_id': 0, 'top_k': 12, 'recency_tau': 64,
                 'query_mode': 'concat', 'query_key': 'inventory_id',
                 'transformer_block': True,
                 'tfm': {'n_layers': 2, 'n_heads': 4, 'mha_dropout': 0.1, 'ffn_hidden': 64,
                         'ffn_dropout': 0.1, 'norm': 'rms', 'gating': 'softmax',
                         'add_positional_bias': True}},
    'model': {'emb_dim': 32, 'seq_vocab': 6000, 'dare_dropout': 0.1, 'embedding_dropout': 0.02,
              'cat_embedding_dims': {'gender': 8, 'age_group': 8, 'inventory_id': 16,
                                     'day_of_week': 8, 'hour': 8, 'l_feat_1': 8, 'l_feat_2': 8},
              'qnn_alpha': {'enabled': True, 'feature_embed_dim': 8, 'heads': 4, 'rank': 8,
                            'proj_dim': 32, 'mlp_hidden': [128, 64], 'dropout': 0.1,
                            'use_se': True, 'se_reduction': 4, 'use_residual': True,
                            'norm': 'rms', 'pair_grouping': 'all', 'aux_head_weight': 0.1}},
    'train': {'batch_size': 1024, 'epochs': 3, 'optimizer': 'adamw', 'lr': 0.002,
              'weight_decay': 0.0001, 'warmup_epochs': 1, 'cosine': True,
              'early_stop_patience': 3, 'grad_clip_norm': 0.5, 'monitor': 'score'},
    'cv': {'n_splits': 1, 'group_key': 'inventory_id', 'stratify_target': 'clicked',
           'time_key': 'day_of_week', 'composite_group': True},
    'eval': {'monitor': 'score', 'maximize': True},
    'calibration': {'enabled': True, 'method': 'temperature', 'lr': 0.05, 'iters': 200},
    'logging': {'log_dir': '/tmp/tossctr_synth/runs', 'tb': False, 'csv_log': True,
                'verbose_steps': 50},
    'ensemble': {'method': 'logit_mean', 'trim_ratio': 0.2, 'weights': [],
                 'val_weight_temperature': 10.0},
    'sampler': {'type': 'None', 'pos_fraction': 0.5},
    'ema': {'enabled': True, 'decay': 0.99, 'eval_with_ema': True},
}


def synth_small_config_dict() -> dict:
    """A fresh copy of ``cfgs/synth_small.yaml``'s mapping."""
    return copy.deepcopy(_SYNTH_SMALL)
