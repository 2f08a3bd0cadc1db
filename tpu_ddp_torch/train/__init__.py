from tpu_ddp_torch.train.lm_steps import (
    create_lm_train_state,
    make_lm_train_step,
    make_sp_lm_train_step,
    token_nll,
)

__all__ = ["create_lm_train_state", "make_lm_train_step", "make_sp_lm_train_step",
           "token_nll"]
