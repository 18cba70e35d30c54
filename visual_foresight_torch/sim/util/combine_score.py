"""Benchmark score reporting (reference ``visual_mpc/sim/util/combine_score.py``).

Per-run results files with mean/median/SEM of improvement and final distance,
combined cross-worker reports, histograms and an improvement-vs-distance
scatter plot.  The txt and pkl reports need numpy alone; matplotlib is
imported for the plots, which are skipped, with a message, where it is
missing.
"""

import glob
import pickle
import re
from collections import OrderedDict

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def write_scores(conf, result_file, stat, i_traj=None):
    improvement = np.asarray(stat['improvement'])
    final_dist = np.asarray(stat['final_dist'])
    initial_dist = np.asarray(stat['initial_dist']) if 'initial_dist' in stat else None
    term_t = np.asarray(stat['term_t']) if 'term_t' in stat else None
    lifted = np.asarray(stat['lifted']).astype(np.int64) if 'lifted' in stat \
        else np.zeros_like(improvement)

    sorted_ind = improvement.argsort()[::-1]
    if i_traj is None:
        i_traj = improvement.shape[0]

    mean_imp, med_imp = np.mean(improvement), np.median(improvement)
    mean_dist, med_dist = np.mean(final_dist), np.median(final_dist)
    print('mean imp, med imp, mean dist, med dist {}, {}, {}, {}'.format(
        mean_imp, med_imp, mean_dist, med_dist))

    with open(result_file, 'w') as f:
        if 'term_dist' in conf['agent'] and term_t is not None:
            tlen = conf['agent']['T']
            nsucc_frac = np.where(term_t != (tlen - 1))[0].shape[0] / improvement.shape[0]
            f.write('percent success: {}%\n---\n'.format(nsucc_frac * 100))
        if 'lifted' in stat:
            f.write('---\nfraction of traj lifted: {}\n---\n'.format(np.mean(lifted)))
        f.write('standard error of the mean (SEM) {}\n---\n'.format(
            np.std(final_dist) / np.sqrt(max(final_dist.shape[0], 1))))
        f.write('overall best pos improvement: {} of traj {}\n'.format(
            improvement[sorted_ind[0]], sorted_ind[0]))
        f.write('overall worst pos improvement: {} of traj {}\n'.format(
            improvement[sorted_ind[-1]], sorted_ind[-1]))
        f.write('average pos improvement: {}\n'.format(mean_imp))
        f.write('median pos improvement {}\n'.format(med_imp))
        f.write('std of population {}\n'.format(np.std(improvement)))
        f.write('SEM {}\n---\n'.format(
            np.std(improvement) / np.sqrt(max(improvement.shape[0], 1))))
        f.write('average pos score: {}\n'.format(mean_dist))
        f.write('median pos score {}\n'.format(med_dist))
        f.write('std of population {}\n'.format(np.std(final_dist)))
        f.write('SEM {}\n---\n'.format(
            np.std(final_dist) / np.sqrt(max(final_dist.shape[0], 1))))
        f.write('mean imp, med imp, mean dist, med dist {}, {}, {}, {}\n---\n'.format(
            mean_imp, med_imp, mean_dist, med_dist))
        if initial_dist is not None:
            f.write('average initial dist: {}\n'.format(np.mean(initial_dist)))
            f.write('median initial dist: {}\n'.format(np.median(initial_dist)))
            f.write('----------------------\n')
        f.write('traj: improv, final_d, rank\n')
        f.write('----------------------\n')
        for n, t in enumerate(range(conf['start_index'], i_traj)):
            if n >= improvement.shape[0]:
                break
            f.write('{}: {}, {}: {}\n'.format(
                t, improvement[n], final_dist[n], np.where(sorted_ind == n)[0][0]))


def sorted_nicely(l):
    convert = lambda text: int(text) if text.isdigit() else text
    alphanum_key = lambda key: [convert(c) for c in re.split('([0-9]+)', key)]
    return sorted(l, key=alphanum_key)


def combine_scores(conf, dir, only_first_n=None):
    files = sorted_nicely(glob.glob(dir + '/scores_*'))
    if len(files) == 0:
        raise ValueError('no score pkls found in {}'.format(dir))

    stats_lists = OrderedDict()
    for fname in files:
        print('load', fname)
        with open(fname, 'rb') as f:
            dict_ = pickle.load(f)
        for key in dict_:
            stats_lists.setdefault(key, []).append(dict_[key])

    stat_array = OrderedDict(
        (key, np.concatenate(vals, axis=0)) for key, vals in stats_lists.items())

    improvement = stat_array['improvement']
    final_dist = stat_array['final_dist']
    if only_first_n is not None:
        improvement = improvement[:only_first_n]
        final_dist = final_dist[:only_first_n]

    plt = _pyplot()
    if plt is None:
        print('matplotlib is not installed: the score plots were skipped')
    make_stats(dir, final_dist, 'finaldist', bounds=[0., 0.5], plt=plt)
    make_stats(dir, improvement, 'improvement', bounds=[-0.5, 0.5], plt=plt)
    if plt is not None:
        make_imp_score(final_dist, improvement, dir, plt)
    write_scores(conf, dir + '/results_all.txt', stat_array)
    print('writing {}'.format(dir))
    return stat_array


def make_imp_score(score, imp, dir, plt):
    plt.figure()
    plt.scatter(imp, score)
    plt.xlabel('improvement')
    plt.ylabel('final distance')
    plt.savefig(dir + '/imp_vs_dist.png')
    plt.close()


def make_stats(dir, score, name, bounds, plt=None):
    """The histogram's bins as text; its plot too where ``plt`` is given."""
    bin_edges = np.linspace(bounds[0], bounds[1], 11)
    binned_ind = np.digitize(score, bin_edges)
    if plt is not None:
        occurrence, _ = np.histogram(score, bin_edges, density=False)
        bin_width = bin_edges[1] - bin_edges[0]
        bin_mid = bin_edges + bin_width / 2
        plt.figure()
        plt.bar(bin_mid[:-1], occurrence, bin_width, facecolor='b', alpha=0.5)
        plt.title(name)
        plt.xlabel(name)
        plt.ylabel('occurrences')
        plt.savefig(dir + '/' + name + '.png')
        plt.close()
    with open(dir + '/{}_histo.txt'.format(name), 'w') as f:
        for i in range(bin_edges.shape[0] - 1):
            f.write('indices for bin {}, {} to {}: {}\n'.format(
                i, bin_edges[i], bin_edges[i + 1],
                np.where(binned_ind == i + 1)[0].tolist()))
